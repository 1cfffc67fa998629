"""Device-batched executors (DESIGN.md §11): tasks/s vs bundle size.

The port of the JAX package's `benchmarks/device_batching.py`.  The
paper's Fig 6 shows per-job batch-scheduler overhead amortizing away as
clustering widens; the accelerator analogue is per-task dispatch + launch
amortizing into one `torch.func.vmap` device call per bundle.  We sweep the
`DeviceExecutorPool`'s `max_bundle` over the same task stream — submitted
through the full Engine -> Falkon -> pool stack, not a raw loop — and
measure end-to-end tasks/s plus the fraction of wall time spent inside
device execution (`pool.device_s / wall`).

The task body is a deliberately *small* multi-op procedure, written the way
a user writes one: at bundle size 1 every task pays op-by-op dispatch (the
overhead under study, ~110 launches a task), while bundles fuse K tasks
into one launch per op.

The reference's two acceptance targets, checked by `check_targets` (the
command line fails when either misses):
  * >= 5x tasks/s at the largest bundle size vs per-task dispatch;
  * >= 80% of wall time inside device execution at the peak-throughput
    bundled configuration.

Run:  python -m repro_torch.benchmarks.device_batching [--device cpu]
          [--tasks 256]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import (DRPConfig, DeviceExecutorPool, Engine,
                              FalkonConfig, FalkonProvider, FalkonService,
                              RealClock)
from repro_torch.launch.op_cost import DurationPredictor

N_TASKS = 256
ROWS = 16
DIM = 192
BUNDLE_SIZES = [1, 4, 16, 64, 256]
REPS = 3
WARM = max(BUNDLE_SIZES)       # tasks run before the timed runs
SPEEDUP_TARGET = 5.0
DEVICE_FRAC_TARGET = 0.8


def small_task(x, w):
    # a small MolDyn-style step as a user writes it: two contractions plus
    # a chain of elementwise ops.  Alone, each op is its own launch — the
    # cost the pool's vmap fusion amortizes; fused, one launch per op
    # serves the whole bundle
    h = torch.tanh(x @ w)
    for _ in range(18):
        h = h * torch.sigmoid(h) + 0.5
        h = torch.abs(h) ** 0.5 - torch.cos(h)
    return torch.sum(h @ w.T, dim=-1)


def make_inputs(n_tasks: int, seed: int = 0):
    """Per-task x (n_tasks, ROWS, DIM) and one shared w (DIM, DIM), f32."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n_tasks, ROWS, DIM), dtype=np.float32)
    w = rng.standard_normal((DIM, DIM), dtype=np.float32)
    return xs, w


def device_stack(clock, executors: int, max_bundle: int, device,
                 dispatchers: int = 1, data_layer=None):
    """Engine + Falkon service backed by a DeviceExecutorPool, with DRP
    pre-sized so one scheduler pump dispatches the whole ready set (the
    bundling-friendly configuration)."""
    pool = DeviceExecutorPool(clock, max_bundle=max_bundle,
                              dispatchers=dispatchers, device=device)
    cfg = FalkonConfig(drp=DRPConfig(
        min_executors=executors, max_executors=executors,
        alloc_latency=0.0, alloc_chunk=executors))
    svc = FalkonService(clock, cfg, data_layer=data_layer, pool=pool)
    svc.provision(executors)
    eng = Engine(clock)
    eng.add_site("dev", FalkonProvider(svc), capacity=executors)
    return eng, svc, pool


def measure(fn, arg_lists: list, max_bundle: int, device, reps: int = REPS,
            dispatchers: int = 1) -> dict:
    """Best of `reps` runs of the stream ``fn(*arg_lists[i])`` through the
    stack, after a warm-up of its first `WARM` tasks (the whole stream at
    the reference's 256).  The counts are those of the best run; `outputs`
    are its results, in task order."""
    n = len(arg_lists)
    eng, svc, pool = device_stack(RealClock(), n, max_bundle, device,
                                  dispatchers)

    def one(tasks):
        before = (pool.device_s, pool.tasks_run, pool.bundles_run,
                  pool.fused_tasks)
        t0 = time.monotonic()
        futs = [eng.submit(f"t{i}", fn, args, vmap_key="mm")
                for i, args in enumerate(tasks)]
        eng.run()
        wall = time.monotonic() - t0
        d_s, d_tasks, d_bundles, d_fused = (
            now - then for now, then in zip(
                (pool.device_s, pool.tasks_run, pool.bundles_run,
                 pool.fused_tasks), before))
        return {"wall_s": wall, "device_s": d_s, "tasks_run": d_tasks,
                "bundles_run": d_bundles, "fused_tasks": d_fused,
                "outputs": [f.get() for f in futs]}

    try:
        one(arg_lists[:WARM])
        best = min((one(arg_lists) for _ in range(reps)),
                   key=lambda r: r["wall_s"])
    finally:
        svc.shutdown()
    best.update(bundle=max_bundle, dispatchers=dispatchers,
                tasks_per_s=n / best["wall_s"],
                device_frac=best["device_s"] / best["wall_s"],
                run_s_mean=best["device_s"] / max(1, best["tasks_run"]))
    return best


def run(n_tasks: int = N_TASKS, device="cuda", reps: int = REPS,
        seed: int = 0, predictor=None) -> dict:
    """The sweep over `BUNDLE_SIZES` of `n_tasks` `small_task`s, drawn by
    `make_inputs(n_tasks, seed)`; `predictor` (default: the reference's
    CPU-priced `DurationPredictor()`) prices one task.

    Returns ``{"sweep": [row, ...], "speedup_largest_vs_single",
    "best_bundled_device_frac", "best_bundle", "predicted_task_s",
    "targets_held"}``; each row is `measure`'s dict (outputs included)."""
    xs, w = make_inputs(n_tasks, seed)
    arg_lists = [[xs[i], w] for i in range(n_tasks)]
    rows = [measure(small_task, arg_lists, b, device, reps)
            for b in BUNDLE_SIZES if b <= n_tasks]
    base, top = rows[0], rows[-1]
    best = max(rows[1:], key=lambda r: r["tasks_per_s"])
    speedup = top["tasks_per_s"] / base["tasks_per_s"]
    # what the scheduler believed, for the same body and shapes
    predicted = (predictor or DurationPredictor()).predict_duration(
        small_task, arg_lists[0])
    return {
        "tasks": n_tasks, "rows": ROWS, "dim": DIM, "device": str(device),
        "sweep": rows,
        "speedup_largest_vs_single": speedup,
        "best_bundled_device_frac": best["device_frac"],
        "best_bundle": best["bundle"],
        "predicted_task_s": predicted,
        "targets_held": {"speedup": speedup >= SPEEDUP_TARGET,
                         "device_frac": best["device_frac"]
                         >= DEVICE_FRAC_TARGET},
    }


def check_targets(summary: dict) -> None:
    """Raise when either of the reference's acceptance targets misses."""
    top = summary["sweep"][-1]
    if not summary["targets_held"]["speedup"]:
        raise AssertionError(
            f"bundled speedup {summary['speedup_largest_vs_single']:.2f}x "
            f"< {SPEEDUP_TARGET}x at bundle={top['bundle']}")
    if not summary["targets_held"]["device_frac"]:
        raise AssertionError(
            f"device fraction {summary['best_bundled_device_frac']:.2f} < "
            f"{DEVICE_FRAC_TARGET} at bundle={summary['best_bundle']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tasks", type=int, default=N_TASKS)
    args = ap.parse_args(argv)
    summary = run(args.tasks, args.device)
    if summary["device"].startswith("cuda"):
        summary["card"] = torch.cuda.get_device_name(0)
    for row in summary["sweep"]:
        print(json.dumps({k: v for k, v in row.items() if k != "outputs"}))
    print(json.dumps({k: v for k, v in summary.items() if k != "sweep"}))
    check_targets(summary)


if __name__ == "__main__":
    main()
