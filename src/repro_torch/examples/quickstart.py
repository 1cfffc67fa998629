"""Quickstart: the layers of the port in one script, the counterpart of the
reference's `examples/quickstart.py`.

1. Workflow: dynamic dataflow over futures (SimClock).
2. Real execution: the same program on worker threads (RealClock).
3. Model zoo: one train step of reduced qwen2-1.5b on the device.
4. The flash-attention kernel against its plain oracle at q (1, 4, 128,
   64), k and v (1, 2, 128, 64), causal, window 64: on the card the CUDA
   kernel (one launch), on the CPU the plain version.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (DRPConfig, Engine, FalkonConfig, FalkonProvider,
                              FalkonService, RealClock, SimClock,
                              ThreadExecutorPool, Workflow)
from repro_torch.device import resolve_device


def _square_sum(wf):
    @wf.atomic
    def square(x):
        return x * x

    @wf.atomic
    def total(xs):
        return sum(xs)

    return total(wf.foreach(list(range(10)), lambda x: square(x)))


def demo_workflow() -> dict:
    clock = SimClock()
    engine = Engine(clock)
    svc = FalkonService(clock, FalkonConfig(
        drp=DRPConfig(max_executors=16, alloc_latency=5.0)))
    engine.add_site("pod0", FalkonProvider(svc), capacity=16)
    wf = Workflow("demo", engine)
    result = _square_sum(wf)
    wf.run()
    return {"sum": result.get(), "dispatched": svc.utilization()["dispatched"],
            "makespan": clock.now(), "stats": engine.stats(), "vdc": engine.vdc.summary()}


def demo_real_execution() -> dict:
    clock = RealClock()
    pool = ThreadExecutorPool(clock)      # DRP acquires real threads
    svc = FalkonService(clock, FalkonConfig(
        drp=DRPConfig(max_executors=8, alloc_latency=0.0, alloc_chunk=8)), pool=pool)
    engine = Engine(clock)
    engine.add_site("pod0", FalkonProvider(svc), capacity=8)
    wf = Workflow("real", engine)
    result = _square_sum(wf)
    wf.run()
    svc.shutdown()
    return {"sum": result.get(), "tasks_run": pool.tasks_run, "workers": len(svc.executors),
            "wall_s": clock.now(), "stats": engine.stats(), "vdc": engine.vdc.summary()}


def demo_model(dev: torch.device, params=None, tokens=None) -> dict:
    """One AdamW train step of reduced qwen2-1.5b: weights from `init_tree`
    (seed 0) and tokens (2, 64) from seed 1, unless given."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_tree
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    cfg = registry.smoke_config("qwen2-1.5b")
    if params is None:
        params = init_tree(T.build_descriptors(cfg),
                           torch.Generator(device=dev).manual_seed(0), dev)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (2, 64), device=dev, dtype=torch.int32,
                               generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = make_train_step(cfg, adamw.Hyper(lr=1e-3))
    params, _, metrics = step(params, adamw.init(params), batch, 0)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}


def demo_kernel(dev: torch.device, qkv=None) -> dict:
    """The flash-attention wrapper against `ref_attention`; q, k, v from
    seeds 2, 3, 4 unless given."""
    from repro_torch.kernels import ops, ref

    if qkv is None:
        qkv = [torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(s))
               for s, shape in ((2, (1, 4, 128, 64)), (3, (1, 2, 128, 64)), (4, (1, 2, 128, 64)))]
    q, k, v = qkv
    out = ops.flash_attention(q, k, v, causal=True, window=64)
    exp = ref.ref_attention(q, k, v, causal=True, window=64)
    return {"out": out, "err": float((out - exp).abs().max())}


def run(device="cuda", *, params=None, tokens=None, qkv=None) -> dict:
    """All four demos; the model and kernel demos on `device`."""
    dev = resolve_device(device)
    out = {"workflow": demo_workflow(), "real": demo_real_execution(),
           "model": demo_model(dev, params, tokens), "kernel": demo_kernel(dev, qkv)}
    out["stats"] = {k: out[k]["stats"] for k in ("workflow", "real")}
    out["vdc"] = {k: out[k]["vdc"] for k in ("workflow", "real")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    w, x, m, k = r["workflow"], r["real"], r["model"], r["kernel"]
    print("== 1. Workflow: dynamic dataflow over futures ==")
    print(f"   sum of squares = {w['sum']}  (dispatched {w['dispatched']} tasks, "
          f"makespan {w['makespan']:.2f}s virtual)")
    print("== 2. Real execution: same program, actual worker threads ==")
    print(f"   sum of squares = {x['sum']}  ({x['tasks_run']} bodies on {x['workers']} real "
          f"workers, {x['wall_s'] * 1e3:.1f} ms wall)")
    print(f"== 3. Model zoo: one train step of qwen2-1.5b (reduced) on {args.device} ==")
    print(f"   loss={m['loss']:.3f} grad_norm={m['grad_norm']:.3f}")
    print(f"== 4. Flash-attention kernel vs its oracle on {args.device} ==")
    print(f"   kernel vs oracle max err = {k['err']:.2e}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
