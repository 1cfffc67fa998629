"""The paper's fMRI spatial-normalization workflow (Fig 1) with torch
compute on a device, the counterpart of the reference's
`examples/fmri_workflow.py`: reorient (an axis permutation), alignlinear
(a least-squares affine fit, `torch.linalg.lstsq`) and reslice over
synthetic brain volumes written as .img/.hdr pairs and mapped from the
file system through XDTM (`FileSystemMapper`).

Run:  PYTHONPATH=src python -m repro_torch.examples.fmri_workflow \\
          [--volumes N] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import Dataset, Engine, FileSystemMapper, RealClock, Workflow
from repro_torch.device import resolve_device

SHAPE = (8, 8, 8)


def make_dataset(root: str, prefix: str, n: int, shape=SHAPE):
    """Write .img/.hdr volume pairs (the paper's physical representation)."""
    rng = np.random.default_rng(0)
    for i in range(n):
        vol = rng.standard_normal(shape).astype(np.float32)
        vol.tofile(os.path.join(root, f"{prefix}_{i:03d}.img"))
        with open(os.path.join(root, f"{prefix}_{i:03d}.hdr"), "w") as f:
            f.write(f"shape={shape}\ndtype=float32\n")
    return Dataset(FileSystemMapper(root, prefix), prefix)


def run(volumes: int = 24, device="cuda") -> dict:
    """Every volume reoriented twice, aligned to the first and resliced."""
    dev = resolve_device(device)
    engine = Engine(RealClock())
    engine.local_site(concurrency=4)
    wf = Workflow("fmri", engine)

    def load(vol):
        return torch.from_numpy(np.fromfile(vol["img"].path, dtype=np.float32)
                                .reshape(SHAPE)).to(dev)

    @wf.atomic
    def reorient(vol, axes):
        x = load(vol) if isinstance(vol, dict) else vol
        return x.permute(axes)

    @wf.atomic
    def alignlinear(ref, x):
        # least-squares scalar affine fit x ~ a*ref + b (an "air" parameter)
        A = torch.stack([ref.reshape(-1), torch.ones(ref.numel(), device=ref.device)], dim=1)
        return torch.linalg.lstsq(A, x.reshape(-1, 1)).solution[:, 0]

    @wf.atomic
    def reslice(x, air):
        return x * air[0] + air[1]

    def reorientRun(run, axes):  # compound procedure (paper lines 13-18)
        return wf.foreach(run, lambda v: reorient(v, axes))

    with tempfile.TemporaryDirectory() as root:
        bold1 = make_dataset(root, "bold1", volumes)
        yr = reorientRun(bold1, (1, 0, 2))
        xr = wf.foreach(yr, lambda v: reorient(v, (1, 0, 2)))

        # align every volume to the first; then reslice (paper lines 19-25)
        def align_and_reslice(vols):
            ref = vols[0]
            airs = [alignlinear(ref, v) for v in vols]
            return wf.gather([reslice(v, a) for v, a in zip(vols, airs)])

        done = wf.foreach(xr, lambda v: v)  # materialize the collection future
        out = wf.when(engine.submit("nonempty", lambda vs: len(vs) > 0, [done]),
                      lambda: align_and_reslice(done.get()))
        wf.run()

    return {"resliced": out.get(), "stats": engine.stats(), "vdc": engine.vdc.summary()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--volumes", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.volumes, args.device)
    print(f"fMRI workflow: {args.volumes} volumes -> {len(r['resliced'])} resliced volumes, "
          f"engine stats: {r['stats']}")
    print(f"provenance: {r['vdc']['invocations']} invocations recorded, "
          f"{r['vdc']['failed']} failures")
    if len(r["resliced"]) != args.volumes:
        raise AssertionError(f"{len(r['resliced'])} resliced volumes of {args.volumes}")


if __name__ == "__main__":
    main()
