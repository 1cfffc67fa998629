"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... --seconds <s>

For each seed, in one process: one run of the cell (its window at the
cell's own load, `--seconds` long) and its check, which reads the
program's numbers and, put in the program's place, the control's: the
plain reference computed in float8 (`reference/common.py::lin`), read at
exactly the positions the program is read.  `correct` is the control's
verdict under the cell's limits; `program_correct` the program's.  With
`--fault`, the run's timed path is broken underneath instead
(`harness/program.py::FAULTS`) and `correct` is the broken program's.
Prints one JSON line a seed and writes them all to
`build/portbench/control/<cell>.json`.  A limit lies above the largest
program reading and below the smallest control reading.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None,
                    help="read a fault planted in the timed path instead of the control")
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import runner
    runner.set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        out = runner.run_cell(ROOT, args.workload, seed, args.seconds, False,
                              control=args.fault is None, fault=args.fault)
        lim = runner.load_cell(ROOT, args.workload).limits.get("limits", {})
        row = {"workload": args.workload, "seed": seed, "fault": args.fault, **out["numbers"],
               "correct": out["result"]["correct"],
               "program_correct": all(out["numbers"][k] <= v["limit"] for k, v in lim.items()),
               "window_s": out["window_s"], "check_s": out["check_s"],
               "setup_s": out["setup_s"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    tag = f".{args.fault}" if args.fault else ""
    path = ROOT / "build" / "portbench" / "control" / f"{args.workload}{tag}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
