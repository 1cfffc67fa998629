"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  `BENCHMARK.json` names the cell; its
configuration, traffic mix, metrics and limits are files under
`portbench/` (see `portbench/harness/spec.py`).  The run needs as many CUDA
cards as the cell asks for and exits 2 without them, printing no result.
It builds the port's kernels into `build/repro_torch/` (the port's fixed
build directory, inside the checkout) on its first run there, keeps every
other cache under `build/portbench/cache/`, and a traced run's Chrome trace
under `build/portbench/trace/`.  The last line of standard output is the
result, as JSON; the numbers compared and their limits close standard
error.  After the window, JAX, its libraries or the JAX package loaded in
this process fail the run.
"""
from __future__ import annotations

import os
import time

_T_PERF = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T_START = _T_PERF - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import runner
    from portbench.harness.guard import forbidden_modules
    from portbench.harness.spec import load_cell
    cell = load_cell(ROOT, args.workload)
    runner.set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    out = runner.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=_T_START, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process, and the port must not load: {bad}", file=sys.stderr)
        return 3
    res = out["result"]
    for key, (value, limit) in out["checks"].items():
        print(f"check {key}: {value!r} (limit {limit!r}, "
              f"{'held' if value <= limit else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
