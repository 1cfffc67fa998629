"""The paper's Montage mosaic workflow (Figs 2/3) with torch compute on a
device, the counterpart of the reference's `examples/montage_workflow.py`:
the overlap table is computed at run time, written as a '|'-delimited
file, mapped back in with `CSVMapper`, and the `mDiffFit` stage fans out
over it (a workflow structure known only at run time); the co-add strategy
is chosen by the run-time image count.

Run:  PYTHONPATH=src python -m repro_torch.examples.montage_workflow \\
          [--images N] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (INT, STRING, CSVMapper, Dataset, Engine, RealClock, Struct,
                              Workflow)
from repro_torch.device import resolve_device

TILE = 16
DiffStruct = Struct("DiffStruct", (
    ("cntr1", INT), ("cntr2", INT), ("plus", STRING), ("minus", STRING),
    ("diff", STRING)))


def run(images: int = 16, device="cuda") -> dict:
    """The mosaic of `images` (TILE, TILE) tiles drawn from seed 1."""
    dev = resolve_device(device)
    n = images
    engine = Engine(RealClock())
    engine.local_site(concurrency=4)
    wf = Workflow("montage", engine)
    rng = np.random.default_rng(1)
    raw = [torch.from_numpy(rng.standard_normal((TILE, TILE)).astype(np.float32)).to(dev)
           + 0.3 * i for i in range(n)]

    @wf.atomic
    def mProjectPP(img):
        # reproject into the common frame (here: a fixed linear warp)
        return torch.flipud(img) * 0.98 + 0.01

    @wf.atomic
    def mOverlaps(imgs, workdir):
        # images overlap if adjacent: structure ONLY known at run time
        path = os.path.join(workdir, "diffs.tbl")
        with open(path, "w") as f:
            f.write("cntr1|cntr2|plus|minus|diff\n")
            for i in range(len(imgs) - 1):
                f.write(f"{i}|{i+1}|p_{i}.fits|p_{i+1}.fits|"
                        f"diff.{i:06d}.{i+1:06d}.fits\n")
        return Dataset(CSVMapper(path, header=True, hdelim="|", types=DiffStruct), "diffs")

    @wf.atomic
    def mDiffFit(rec, imgs):
        d = imgs[rec["cntr1"]] - imgs[rec["cntr2"]]
        return torch.stack([d.mean(), d.std(correction=0)])

    @wf.atomic
    def mBgModel(fits):
        return torch.stack(fits).mean(dim=0)

    @wf.atomic
    def mBackground(img, model):
        return img - model[0]

    @wf.atomic
    def mAdd(imgs):
        return torch.stack(imgs).mean(dim=0)

    with tempfile.TemporaryDirectory() as workdir:
        projected = wf.gather([mProjectPP(im) for im in raw])
        tbl = mOverlaps(projected, workdir)
        # dynamic fan-out: the row count is a run-time property of tbl
        fits = wf.foreach(tbl, lambda rec: mDiffFit(rec, projected))
        model = mBgModel(fits)
        rectified = wf.foreach(projected, lambda im: mBackground(im, model))
        # conditional co-add strategy on the run-time size (paper §3.6)
        big = engine.submit("is_big", lambda ims: len(ims) > 8, [rectified])

        def coadd_subregions():
            sub = 4

            def part(i):
                return wf.when(rectified, lambda i=i: mAdd(rectified.get()[i::sub]))
            parts = wf.gather([part(i) for i in range(sub)])
            return wf.when(parts, lambda: mAdd(parts.get()))

        mosaic = wf.when(big, coadd_subregions, lambda: mAdd(rectified.get()))
        wf.run()

    return {"mosaic": mosaic.get(), "diff_fits": len(engine.vdc.by_task("mDiffFit")),
            "stats": engine.stats(), "vdc": engine.vdc.summary()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.images, args.device)
    m = r["mosaic"]
    print(f"montage: {args.images} images, mosaic shape {tuple(m.shape)}, "
          f"mean {float(m.mean()):+.4f}")
    print(f"engine: {r['stats']}")
    print(f"dynamic expansion created {r['diff_fits']} mDiffFit tasks at run time")
    if r["diff_fits"] != args.images - 1:
        raise AssertionError(f"{r['diff_fits']} mDiffFit tasks for {args.images} images")


if __name__ == "__main__":
    main()
