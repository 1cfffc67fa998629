"""Device-native clustering (DESIGN.md §2): vmap-bundling of small torch tasks.

The port of the JAX package's `benchmarks/vmap_clustering.py`.  The paper's
clustering amortizes batch-scheduler overhead; on an accelerator the
analogous per-task cost is dispatch + launch of many small computations.
We measure N small matmul tasks executed (a) one device call each through
the engine and (b) fused into vmapped bundles — the measured analogue of
the paper's 2-4x clustering win.  Steady state (the vmap cache warm),
inputs host-resident as real workflow task data would be, the shared
weight on the device.

Both runs go through `VmapClusteringProvider(device=...)` on an engine:
the fused run submits every task with a `vmap_key`; the per-task run
submits them without one, so each runs alone on the same device (the
reference's per-task run uses a local site, where a JAX body reaches the
device by itself; a torch body handed a numpy array would not).

`check` holds the reference's assertions: every task fused, and a
speedup of at least 1.5x; the command fails when either misses.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.vmap_clustering [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import Engine, RealClock
from repro_torch.core.clustering import VmapClusteringProvider
from repro_torch.device import resolve_device

N_TASKS = 256
DIM = 64
SPEEDUP_FLOOR = 1.5


def small_task(x, w):
    # a "plain procedure" as a user would write it: each per-task execution
    # pays op-by-op dispatch; the clustering provider is the layer that
    # vmaps the bundle (like the paper's clustering wraps un-optimized jobs)
    return torch.tanh(x @ w).sum() * 0.5 + 1.0


def _mk_engine(device):
    eng = Engine(RealClock())
    prov = VmapClusteringProvider(eng.clock, window=0.0, max_bundle=N_TASKS,
                                  device=device)
    eng.add_site("dev", prov, capacity=N_TASKS)
    return eng, prov


def _submit_all(eng, xs, w, cluster: bool):
    key = ("mm", DIM) if cluster else None
    t0 = time.monotonic()
    outs = [eng.submit(f"t{i}", small_task, [xs[i], w], vmap_key=key)
            for i in range(N_TASKS)]
    eng.run()
    dt = time.monotonic() - t0
    assert all(o.resolved for o in outs)
    return dt, [o.get() for o in outs]


def run(device="cuda", seed: int = 0) -> dict:
    """Best of 3 of each run after a warm-up; returns the times, the
    speedup, tasks/s of each, the fused run's bundles and fused tasks, and
    both runs' outputs (host tensors, in task order).  `check` holds the
    result to the reference's assertions."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((N_TASKS, DIM, DIM), dtype=np.float32)
    w = torch.from_numpy(rng.standard_normal((DIM, DIM), dtype=np.float32)).to(device)

    eng_c, prov = _mk_engine(device)
    _submit_all(eng_c, xs, w, True)         # warm the vmapped call
    fused_before = prov.fused_tasks
    t_cluster, out_c = min((_submit_all(eng_c, xs, w, True) for _ in range(3)),
                           key=lambda r: r[0])

    eng_s, _ = _mk_engine(device)
    _submit_all(eng_s, xs, w, False)
    t_single, out_s = min((_submit_all(eng_s, xs, w, False) for _ in range(3)),
                          key=lambda r: r[0])

    return {"tasks": N_TASKS, "dim": DIM, "device": str(device),
            "per_task_s": t_single, "clustered_s": t_cluster,
            "speedup": t_single / t_cluster, "tasks_per_s_fused": N_TASKS / t_cluster,
            "tasks_per_s_per_task": N_TASKS / t_single,
            "bundles": prov.bundles_executed,
            "fused_per_run": (prov.fused_tasks - fused_before) // 3,
            "outputs_fused": torch.stack(out_c),
            "outputs_per_task": torch.stack(out_s)}


def check(res: dict) -> None:
    """The reference's regression bounds: clustering must actually fuse and
    must show a clear amortization win (the paper's clustering band is
    2-4x; the floor sits below it to absorb noisy shared hosts)."""
    assert res["fused_per_run"] >= N_TASKS, \
        f"only {res['fused_per_run']}/{N_TASKS} tasks fused"
    assert res["speedup"] >= SPEEDUP_FLOOR, \
        f"clustering speedup {res['speedup']:.2f}x < {SPEEDUP_FLOOR}x"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    print(json.dumps({k: v for k, v in res.items()
                      if not k.startswith("outputs")}))
    check(res)


if __name__ == "__main__":
    main()
