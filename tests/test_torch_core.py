"""The port's copy of the scheduling stack (`repro_torch.core`) against the
JAX package's (`repro.core`) under `SimClock`.

Each scenario takes the `core` package as a parameter, runs the same seeded
workload through it and returns what a user reads back: the values, the
simulated makespan, `engine.stats()`, `FalkonService.utilization()`, the
provenance record count and the observability report's task counts.  Both
packages must return equal results.
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("repro.core", "repro_torch.core")


def _report_tasks(core, tracer, makespan):
    return core.build_report(tracer, makespan=makespan)["tasks"]


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def moldyn_drp(core, tmp_path):
    """MolDyn's shape (1 + 21 per molecule: antechamber, equilibrate, 17
    perturbations, wham) on Falkon with DRP's allocation latency."""
    clock = core.SimClock()
    tracer = core.Tracer()
    eng = core.Engine(clock, tracer=tracer)
    svc = core.FalkonService(clock, core.FalkonConfig(drp=core.DRPConfig(
        max_executors=48, alloc_latency=81.0, alloc_chunk=16)))
    eng.add_site("anl_tg", core.FalkonProvider(svc), capacity=48)
    wf = core.Workflow("moldyn", eng)
    rng = np.random.default_rng(0)
    pert_s = rng.uniform(20.0, 60.0, size=17).tolist()

    annotate = wf.atomic(lambda: 0.5, name="annotate", duration=30.0,
                         durable=True)
    antechamber = wf.atomic(lambda c, m: c * (m + 1), name="antechamber",
                            duration=12.0)
    equil = wf.atomic(lambda t: t + 1.0, name="charmm_eq", duration=45.0)
    perts = [wf.atomic(lambda s, k=k: s * (k + 1), name=f"charmm_pert{k}",
                       duration=pert_s[k]) for k in range(17)]
    wham = wf.atomic(lambda es: sum(es), name="wham", duration=8.0)

    charges = annotate()

    def molecule(m):
        eq = equil(antechamber(charges, m))
        return wham(wf.gather([p(eq) for p in perts]))

    out = wf.foreach(list(range(12)), molecule)
    wf.run()
    makespan = clock.now()
    return {"values": out.get(), "makespan": makespan,
            "stats": eng.stats(), "util": svc.utilization(),
            "provenance": eng.vdc.summary(),
            "report": _report_tasks(core, tracer, makespan)}


def retries_under_faults(core, tmp_path):
    """Two Falkon sites, a seeded injector failing 20% of attempts, up to 8
    retries with backoff."""
    clock = core.SimClock()
    tracer = core.Tracer()
    inj = core.FaultInjector(seed=7, clock=clock).fail_probability(0.2)
    eng = core.Engine(clock, tracer=tracer, fault_injector=inj,
                      retry_policy=core.RetryPolicy(max_retries=8,
                                                    backoff=1.0))
    svcs = []
    for i in range(2):
        svc = core.FalkonService(clock, core.FalkonConfig(
            drp=core.DRPConfig(max_executors=16, alloc_latency=5.0,
                               alloc_chunk=8)), name=f"site{i}")
        eng.add_site(f"site{i}", core.FalkonProvider(svc), capacity=16)
        svcs.append(svc)
    outs = [eng.submit(f"t{i}", lambda i=i: i * i, duration=1.0 + (i % 5))
            for i in range(400)]
    eng.run()
    makespan = clock.now()
    return {"values": [o.get() if o.resolved else None for o in outs],
            "makespan": makespan, "stats": eng.stats(),
            "util": [s.utilization() for s in svcs],
            "provenance": eng.vdc.summary(),
            "failures": len(eng.vdc.failures()),
            "report": _report_tasks(core, tracer, makespan)}


def restart_log_resume(core, tmp_path):
    """A durable run that crashes from item 5 on, then a restart from the
    same log that restores what the first run produced."""
    log_path = os.path.join(tmp_path, f"{core.__name__}.rlog")
    calls = []

    def make(fail_at):
        clock = core.SimClock()
        eng = core.Engine(clock, restart_log=core.RestartLog(log_path))
        eng.local_site(concurrency=4)
        wf = core.Workflow("w", eng)

        @wf.atomic(durable=True, duration=2.0)
        def work(i):
            if fail_at is not None and i >= fail_at:
                raise RuntimeError("crash")
            calls.append(i)
            return i * 10

        return eng, wf, work

    eng, wf, work = make(fail_at=5)
    first = [work(i) for i in range(12)]
    wf.run()
    done_first = sum(o.resolved for o in first)
    calls.clear()
    eng2, wf2, work2 = make(fail_at=None)
    second = [work2(i) for i in range(12)]
    wf2.run()
    restored = eng2.stats()["restored_from_log"]
    assert 0 < done_first < 12 and restored == done_first > 0
    return {"values": [o.get() for o in second], "done_first": done_first,
            "reran": sorted(calls), "stats": [eng.stats(), eng2.stats()],
            "provenance": [eng.vdc.summary(), eng2.vdc.summary()]}


def data_layer_cache(core, tmp_path):
    """256 tasks over 8 shared 100 MB files through executor caches."""
    clock = core.SimClock()
    shared = core.SharedStore()
    dl = core.DataLayer(shared, core.StagingCostModel(),
                        cache_capacity=400e6, policy="lru")
    svc = core.FalkonService(clock, core.FalkonConfig(
        drp=core.DRPConfig(max_executors=16, alloc_latency=1.0,
                           alloc_chunk=16)), data_layer=dl)
    eng = core.Engine(clock, provenance="summary")
    eng.add_site("falkon", core.FalkonProvider(svc), capacity=16)
    wf = core.Workflow("t", eng)
    files = [shared.file(f"f{i}.dat", 100e6) for i in range(8)]
    proc = wf.sim_proc("analyze", duration=1.0,
                       inputs=lambda i: (files[i % 8],))
    out = wf.foreach(list(range(256)), lambda i: proc(i))
    wf.run()
    assert out.resolved and dl.hit_rate() > 0.9
    return {"makespan": clock.now(), "stats": eng.stats(),
            "util": svc.utilization(), "hit_rate": dl.hit_rate(),
            "hits": dl.hits, "misses": dl.misses,
            "bytes_staged": dl.bytes_staged,
            "per_executor": [e.tasks_done for e in svc.executors],
            "provenance": eng.vdc.summary()}


def batch_scheduler_vs_falkon(core, tmp_path):
    """The same stream on a PBS-like batch provider and on Falkon, side by
    side under one engine."""
    clock = core.SimClock()
    eng = core.Engine(clock)
    pbs = core.BatchSchedulerProvider(clock, nodes=32, submit_rate=2.0,
                                      sched_latency=30.0)
    svc = core.FalkonService(clock, core.FalkonConfig(
        drp=core.DRPConfig(max_executors=32, alloc_latency=81.0,
                           alloc_chunk=32)))
    s_pbs = eng.add_site("pbs", pbs, capacity=32)
    s_falkon = eng.add_site("falkon", core.FalkonProvider(svc), capacity=32)
    outs = [eng.submit(f"job{i}", lambda i=i: i + 1, duration=10.0)
            for i in range(300)]
    eng.run()
    return {"values": [o.get() for o in outs], "makespan": clock.now(),
            "stats": eng.stats(), "util": svc.utilization(),
            "split": (s_pbs.stats.submitted, s_falkon.stats.submitted),
            "admissions": pbs.admission_events,
            "provenance": eng.vdc.summary()}


def foreach_window_streaming(core, tmp_path):
    """`foreach(window=16)` over a 1,000-item generator with a fold."""
    clock = core.SimClock()
    tracer = core.Tracer()
    eng = core.Engine(clock, tracer=tracer)
    svc = core.FalkonService(clock, core.FalkonConfig(
        drp=core.DRPConfig(max_executors=8, alloc_latency=0.0,
                           alloc_chunk=8)))
    eng.add_site("falkon", core.FalkonProvider(svc), capacity=8)
    wf = core.Workflow("stream", eng)
    step = wf.atomic(lambda x: 3 * x, name="step", duration=0.5)
    total = wf.foreach((i for i in range(1000)), step, window=16,
                       reduce=lambda acc, v: acc + v, init=0)
    wf.run()
    makespan = clock.now()
    return {"total": total.get(), "makespan": makespan,
            "stats": eng.stats(), "util": svc.utilization(),
            "provenance": eng.vdc.summary(),
            "report": _report_tasks(core, tracer, makespan)}


def health_straggler(core, tmp_path):
    """A rolling p95 built from 12 one-second tasks, then one task of 40 s:
    flagged once, with a re-dispatch hint."""
    clock = core.SimClock()
    tracer = core.Tracer()
    hints = []
    cfg = core.HealthConfig(window=10.0, buckets=5, min_samples=6,
                            duration_window=60.0, duration_stride=1,
                            straggler_factor=3.0, straggler_min_s=1.0,
                            straggler_interval=2.0)
    eng = core.Engine(clock, tracer=tracer, provenance="summary",
                      retry_policy=core.RetryPolicy(max_retries=8,
                                                    backoff=1.0))
    svc = core.FalkonService(clock, core.FalkonConfig(drp=core.DRPConfig(
        max_executors=6, alloc_latency=0.0, alloc_chunk=6),
        host_suspend_time=300.0), name="site0")
    svc.provision(6)
    eng.add_site("site0", core.FalkonProvider(svc), capacity=6)
    hm = core.HealthMonitor(clock, cfg, tracer=tracer,
                            on_straggler=lambda t, a, thr: hints.append(
                                (t.name, a, thr)))
    hm.watch(eng)
    outs = [eng.submit("work", None, duration=1.0) for _ in range(12)]
    eng.run()
    slow = eng.submit("work", None, duration=40.0)
    eng.run()
    assert all(o.resolved for o in outs) and slow.resolved
    assert hm.stragglers_flagged == 1
    makespan = clock.now()
    return {"hints": hints, "flagged": hm.stragglers_flagged,
            "transitions": hm.transition_log_json(),
            "site": hm.metrics()["sites"]["site0"],
            "makespan": makespan, "stats": eng.stats(),
            "util": svc.utilization(),
            "report": _report_tasks(core, tracer, makespan)}


SCENARIOS = [moldyn_drp, retries_under_faults, restart_log_resume,
             data_layer_cache, batch_scheduler_vs_falkon,
             foreach_window_streaming, health_straggler]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_stack_equals_reference(scenario, tmp_path):
    ref, port = (scenario(importlib.import_module(name), tmp_path)
                 for name in PACKAGES)
    assert port == ref


# the one line of a copy that differs from the reference's text otherwise:
# its docstring names the observability module, not the change that made it
DOC_EDITS = {"health": (3, "The `Tracer`/`RunReport` of `observability` explain")}


def test_copied_modules_differ_only_in_package_name():
    """Each copied module is the reference's text with `repro.core` renamed
    (and `DOC_EDITS`), but for `task.py`, whose `arg_signature` adds a
    tensor's device."""
    copied = ["futures", "simclock", "metrics", "faults", "provenance",
              "xdtm", "restart_log", "sites", "providers", "health",
              "observability", "falkon", "datastore", "engine", "workflow",
              "realpool"]
    for m in copied:
        ref = (REPO / "src/repro/core" / f"{m}.py").read_text()
        port = (REPO / "src/repro_torch/core" / f"{m}.py").read_text()
        ref = ref.replace("repro.core", "repro_torch.core").splitlines()
        port = port.splitlines()
        assert len(port) == len(ref), m
        differ = [i for i, (a, b) in enumerate(zip(port, ref)) if a != b]
        if m in DOC_EDITS:
            line, start = DOC_EDITS[m]
            assert differ == [line] and port[line].startswith(start), m
        else:
            assert differ == [], m


def test_numpy_signatures_equal_and_tensors_carry_device():
    import torch
    from repro.core.task import arg_signature as ref_sig
    from repro_torch.core.task import arg_signature as port_sig

    args = [np.ones((4, 3), np.float32), np.zeros((2,), np.int64), 3, 2.5,
            "s", [1, 2]]
    assert np.ones(1).device == "cpu"       # numpy 2 arrays carry .device
    assert port_sig(args) == ref_sig(args)
    t = torch.ones(4, 3)
    assert port_sig([t]) == (((4, 3), "torch.float32", "cpu"),)
    assert port_sig([t]) != port_sig([torch.ones(4, 3, device="meta")])


def test_port_core_imports_no_jax():
    """In a fresh interpreter: the port's scheduling stack, device tier,
    predictor and benchmark leave `jax` and `repro` out of sys.modules."""
    code = ("import sys, repro_torch.core, repro_torch.core.devicepool, "
            "repro_torch.launch.op_cost, "
            "repro_torch.benchmarks.device_batching; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_import_walk_covers_the_scheduling_stack():
    """`test_torch_serve.py::test_port_imports_neither_jax_nor_the_jax_package`
    globs every `.py` under `src/repro_torch`: the new directories are in
    that walk, and their files import neither package."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    dirs = {f.parent.name for f in files}
    assert {"core", "launch", "benchmarks"} <= dirs
    new = [f for f in files if f.parent.name in ("core", "launch",
                                                 "benchmarks")]
    assert len(new) >= 22
    for f in new:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module and node.level == 0 else [])
            assert not [n for n in names
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")], f
