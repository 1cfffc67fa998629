"""Three-term roofline table from the dry run's artifacts.

The counterpart of the JAX package's `benchmarks/roofline.py`.  Reads
`build/dryrun/*.json` (written by `python -m repro_torch.launch.dryrun`)
and prints, per (arch x shape x mesh) cell: per-device argument, output
and temp GB and whether they fit an 80 GB card, the compute, memory and
collective terms in seconds, the dominant one, MODEL_FLOPS / traced FLOPs
(the useful ratio) and the roofline-bound MFU; then each failed cell
(`<tag>.err`) with the last line of its traceback.  The table is saved
beside the artifacts as `roofline_table.json`.  Every number is a
prediction for H100 SXM 700 W cards (`repro_torch.launch.roofline.HW`),
made on the host; none is a measurement.

With `--against DIR`, it prints instead each cell found in both
directories beside the other's: the ratio of its FLOPs, HBM bytes, temp
bytes and collective wire bytes to the other's, both memory and collective
terms, both dominant terms and
both "fits 80 GB" verdicts, then the ratios' medians and the number of
cells whose dominant terms and fits agree.  DIR holds JSON with the same keys: the JAX
package's dry run (`python -m repro.launch.dryrun --all --both-meshes
--out DIR`) or this one's under another torch.  The other's dominant term
and fit are worked out from its counts against the same `HW`, so no TPU
figure enters.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--dir build/dryrun]
           [--against DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import HW, CollectiveStats, roofline


def load_cells(dryrun_dir: str) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        if os.path.basename(path) == "roofline_table.json":
            continue
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def table(dryrun_dir: str) -> list[dict]:
    rows = []
    for rec in load_cells(dryrun_dir):
        r, m = rec["roofline"], rec["memory"]
        rows.append({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "kind": rec["kind"],
            "arg_gb": m["argument_bytes"] / 1e9,
            "out_gb": m["output_bytes"] / 1e9,
            "temp_gb": m["temp_bytes"] / 1e9,
            "fits_80gb": m["fits_80gb"],
            "compute_s": r["compute_term_s"],
            "memory_s": r["memory_term_s"],
            "collective_s": r["collective_term_s"],
            "dominant": r["dominant"],
            "useful_ratio": r.get("useful_flops_ratio"),
            "mfu_bound": r.get("mfu_bound"),
        })
    return rows


def failures(dryrun_dir: str) -> list[tuple[str, str]]:
    """(tag, the traceback's last line) of every failed cell."""
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.err"))):
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        out.append((os.path.basename(path)[:-4], lines[-1] if lines else ""))
    return out


def _pair(vals) -> str:
    return " / ".join(vals)


def _device_gb(r: dict) -> str:
    """What one device holds at the step's peak: its inputs and temps."""
    return f"{r['arg_gb'] + r['temp_gb']:.2f}"


def markdown(rows: list[dict], fails: list[tuple[str, str]]) -> list[str]:
    """One row per (arch, shape), each column "16x16 / 2x16x16"; a failed
    cell reads FAIL and is listed with its error below the table."""
    meshes = ("16x16", "2x16x16")
    by_cell: dict = {}
    for r in rows:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    failed = {}
    for tag, err in fails:
        arch, shape, mesh = tag.split("__")
        by_cell.setdefault((arch, shape), {})
        failed[(arch, shape, mesh)] = err

    def col(cell, key, fmt):
        out = []
        for m in meshes:
            r = by_cell[cell].get(m)
            out.append("FAIL" if (*cell, m) in failed else
                       "—" if r is None else fmt(r[key]) if key else fmt(r))
        return _pair(out)

    lines = ["| arch | shape | arg + temp GB/device | fits 80 GB | compute s | memory s "
             "| collective s | dominant | useful | mfu_bound |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for cell in sorted(by_cell):
        lines.append(
            f"| {cell[0]} | {cell[1]} "
            f"| {col(cell, None, _device_gb)} "
            f"| {col(cell, 'fits_80gb', lambda v: 'yes' if v else 'no')} "
            f"| {col(cell, 'compute_s', lambda v: f'{v:.4g}')} "
            f"| {col(cell, 'memory_s', lambda v: f'{v:.4g}')} "
            f"| {col(cell, 'collective_s', lambda v: f'{v:.4g}')} "
            f"| {col(cell, 'dominant', str)} "
            f"| {col(cell, 'useful_ratio', lambda v: f'{v or 0:.3f}')} "
            f"| {col(cell, 'mfu_bound', lambda v: f'{v or 0:.4f}')} |")
    for (arch, shape, mesh), err in sorted(failed.items()):
        lines.append(f"FAIL {arch} {shape} {mesh}: {err}")
    return lines


def _counts(rec: dict) -> dict:
    """The counts of one cell's JSON, its dominant term and fit under `HW`."""
    r, m = rec["roofline"], rec["memory"]
    flops, nbytes = r["hlo_flops_per_device"], r["hlo_bytes_per_device"]
    wire = r["collective_bytes_per_device"]
    roof = roofline({"flops": flops, "bytes accessed": nbytes},
                    CollectiveStats(per_device_wire_bytes=wire), rec["n_chips"])
    return {"flops": flops, "bytes": nbytes, "temp": m["temp_bytes"], "wire": wire,
            "memory_s": roof["memory_term_s"], "collective_s": roof["collective_term_s"],
            "dominant": roof["dominant"],
            "fits": m["argument_bytes"] + m["temp_bytes"] <= HW["hbm_bytes"]}


def against(dryrun_dir: str, other_dir: str) -> list[str]:
    """A markdown table of every cell in both directories: this run's count
    over the other's, and each one's dominant term and fit (this / other)."""
    other = {(c["arch"], c["shape"], c["mesh"]): c for c in load_cells(other_dir)}
    lines = ["| arch | shape | mesh | FLOPs | HBM bytes | temp bytes | collective bytes "
             "| temp GB | memory s | collective s | dominant | fits 80 GB |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]

    def ratio(a, b):
        return f"{a / b:.3f}" if b else ("—" if not a else "inf")

    for rec in sorted(load_cells(dryrun_dir), key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        key = (rec["arch"], rec["shape"], rec["mesh"])
        if key not in other:
            continue
        a, b = _counts(rec), _counts(other[key])
        lines.append(
            f"| {' | '.join(key)} | {ratio(a['flops'], b['flops'])} "
            f"| {ratio(a['bytes'], b['bytes'])} | {ratio(a['temp'], b['temp'])} "
            f"| {ratio(a['wire'], b['wire'])} | {a['temp'] / 1e9:.2f} / {b['temp'] / 1e9:.2f} "
            f"| {a['memory_s']:.4g} / {b['memory_s']:.4g} "
            f"| {a['collective_s']:.4g} / {b['collective_s']:.4g} "
            f"| {a['dominant']} / {b['dominant']} "
            f"| {'yes' if a['fits'] else 'no'} / {'yes' if b['fits'] else 'no'} |")
    return lines


def agreement(dryrun_dir: str, other_dir: str) -> str:
    """One line under `against`'s table: the median of each count's ratio
    over the cells in both directories, and in how many of them the
    dominant terms and the fits agree."""
    import statistics

    other = {(c["arch"], c["shape"], c["mesh"]): c for c in load_cells(other_dir)}
    pairs = [(_counts(c), _counts(other[(c["arch"], c["shape"], c["mesh"])]))
             for c in load_cells(dryrun_dir) if (c["arch"], c["shape"], c["mesh"]) in other]
    if not pairs:
        return "no cell in both directories"
    med = {k: statistics.median(a[k] / b[k] for a, b in pairs if b[k])
           for k in ("flops", "bytes", "temp", "wire")}
    return (f"{len(pairs)} cells; medians of the ratios: FLOPs {med['flops']:.3f}, "
            f"HBM bytes {med['bytes']:.3f}, temp bytes {med['temp']:.3f}, "
            f"wire bytes {med['wire']:.3f}; dominant agrees in "
            f"{sum(a['dominant'] == b['dominant'] for a, b in pairs)}, fits in "
            f"{sum(a['fits'] == b['fits'] for a, b in pairs)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if args.against:
        print("\n".join(against(args.dir, args.against)))
        print(agreement(args.dir, args.against))
        return 0
    rows = table(args.dir)
    fails = failures(args.dir)
    if not rows and not fails:
        print(f"no dry-run artifacts in {args.dir}: run "
              "python -m repro_torch.launch.dryrun --all first")
        return 1
    print("\n".join(markdown(rows, fails)))
    with open(os.path.join(args.dir, "roofline_table.json"), "w") as f:
        json.dump({"cells": rows, "failed": [{"tag": t, "error": e} for t, e in fails]},
                  f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
