"""The port's device tier (`repro_torch.core.clustering`,
`repro_torch.core.devicepool`, the task bodies of `repro_torch.kernels.ops`,
`repro_torch.launch.op_cost` and `repro_torch.benchmarks.device_batching`)
on the CPU (``device="cpu"``), against the JAX package's on the same numpy
inputs.

Tolerances:
  * the port's bundle against the reference's bundle: f32 2e-5
    (tests/test_kernels.py's f32 tolerance);
  * per task against the bundle: rtol 1e-4, atol 1e-5.  A bundle
    broadcasts the shared weight, so its products may sum in another order
    than one task's: the reference's own per-task-vs-bundle test misses its
    rtol 1e-5 by exactly that (8.3e-5 relative, at its smallest output).

The `cuda` cases run the pool on the card and skip without one.  The JAX
package is imported only inside fixtures, so that they also run where JAX
is not installed.
"""
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import device_batching as bench  # noqa: E402
from repro_torch.core import (DRPConfig, DataLayer, DeviceExecutorPool,  # noqa: E402
                              Engine, FalkonConfig, FalkonProvider,
                              FalkonService, FaultInjector, RealClock,
                              RetryPolicy, SharedStore, SimClock,
                              TaskFailure, Workflow)
from repro_torch.core import devicepool  # noqa: E402
from repro_torch.core.clustering import (VmapClusteringProvider,  # noqa: E402
                                         execute_bundle, vmap_signature)
from repro_torch.kernels.ops import attention_task, matmul_task  # noqa: E402
from repro_torch.launch.op_cost import DeviceModel, DurationPredictor  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=2e-5, atol=2e-5)
PER_TASK = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's device tier and task bodies."""
    jax = pytest.importorskip("jax")
    sys.path.insert(0, str(REPO))
    from benchmarks import device_batching as jbench
    from repro.core import clustering
    from repro.kernels import ops
    from repro.launch import hlo_cost
    return types.SimpleNamespace(jax=jax, clustering=clustering, ops=ops,
                                 hlo_cost=hlo_cost, small_task=jbench.small_task)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pool runs its bundles on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as on the CPU
    return torch.device("cuda")


def _tasks(fn, arg_lists, fault_check=None):
    return [types.SimpleNamespace(fn=fn, args=list(a), fault_check=fault_check)
            for a in arg_lists]


def _body_inputs(name, n, seed=0):
    """Per-task numpy arguments of each task body; the weight is one object
    shared by every task, as the benchmark shares it."""
    rng = np.random.default_rng(seed)
    if name == "matmul_task":
        w = rng.standard_normal((32, 32), dtype=np.float32)
        return [[rng.standard_normal((32,), dtype=np.float32), w]
                for _ in range(n)]
    if name == "attention_task":
        return [[rng.standard_normal((2, 16, 8), dtype=np.float32)
                 for _ in range(3)] for _ in range(n)]
    xs, w = bench.make_inputs(n, seed)
    return [[xs[i], w] for i in range(n)]


PORT_BODIES = {"matmul_task": matmul_task, "attention_task": attention_task,
               "small_task": bench.small_task}


def _ref_body(ref, name):
    return ref.small_task if name == "small_task" else getattr(ref.ops, name)


def _device_stack(executors=16, max_bundle=16, **kw):
    return bench.device_stack(RealClock(), executors, max_bundle, "cpu", **kw)


def body(x, w):
    return torch.sum(torch.tanh(x @ w), dim=-1) + x


# ---------------------------------------------------------------------------
# execute_bundle: the port's bundle against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PORT_BODIES))
def test_bundle_matches_reference_bundle(ref, name):
    args = _body_inputs(name, 12)
    j_res, _, j_fused = ref.clustering.execute_bundle(
        _ref_body(ref, name), _tasks(_ref_body(ref, name), args), {})
    t_res, exec_s, t_fused = execute_bundle(
        PORT_BODIES[name], _tasks(PORT_BODIES[name], args), {}, "cpu")
    assert j_fused == t_fused == 12 and exec_s > 0
    for (jok, jv, _), (tok, tv, _) in zip(j_res, t_res):
        assert jok and tok
        assert isinstance(tv, torch.Tensor) and tv.device.type == "cpu"
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)


@pytest.mark.parametrize("name", sorted(PORT_BODIES))
def test_per_task_matches_bundle(name):
    fn = PORT_BODIES[name]
    args = _body_inputs(name, 12, seed=1)
    res, _, fused = execute_bundle(fn, _tasks(fn, args), {}, "cpu")
    assert fused == 12
    for (ok, v, _), a in zip(res, args):
        one = fn(*[torch.from_numpy(x) for x in a])
        torch.testing.assert_close(v, one, **PER_TASK)


def test_all_shared_bundle_falls_back_in_both_packages(ref):
    x, w = np.ones((8,), np.float32), np.ones((8, 8), np.float32)
    j_res, _, j_fused = ref.clustering.execute_bundle(
        ref.ops.matmul_task, _tasks(ref.ops.matmul_task, [[x, w]] * 4), {})
    t_res, _, t_fused = execute_bundle(
        matmul_task, _tasks(matmul_task, [[x, w]] * 4), {}, "cpu")
    assert j_fused == t_fused == 0
    for (jok, jv, _), (tok, tv, _) in zip(j_res, t_res):
        assert jok and tok
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)


def test_singletons_and_fallback_get_numpy_args_on_the_device():
    seen = []

    def probe(x):
        seen.append((type(x), x.device.type))
        return x + 1

    x = np.ones((3,), np.float32)
    res, _, fused = execute_bundle(probe, _tasks(probe, [[x]]), {}, "cpu")
    assert fused == 0 and res[0][0]
    # all-shared: the fused path raises and every task runs per task
    res, _, fused = execute_bundle(probe, _tasks(probe, [[x]] * 3), {}, "cpu")
    assert fused == 0 and all(ok for ok, _, _ in res)
    assert seen == [(torch.Tensor, "cpu")] * 4


def test_execute_bundle_and_pool_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    x = np.ones((3,), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_bundle(matmul_task, _tasks(matmul_task, [[x, x]]), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceExecutorPool(RealClock())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VmapClusteringProvider(SimClock())


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def test_vmap_signature_separates_shapes_callables_and_devices(ref):
    def f(x):
        return x

    a4, a8 = np.ones((4,), np.float32), np.ones((8,), np.float32)
    assert vmap_signature(f, [a4]) == vmap_signature(f, [a4])
    assert vmap_signature(f, [a4]) != vmap_signature(f, [a8])
    assert vmap_signature(f, [a4]) != vmap_signature(lambda x: x, [a4])
    t = torch.ones(4)
    assert vmap_signature(f, [t]) != vmap_signature(f, [t.to("meta")])
    assert vmap_signature(f, [t]) != vmap_signature(f, [a4])
    for args in ([a4], [a8, 3, 2.5], [np.ones((2, 3), np.int32), "s"]):
        assert (vmap_signature(f, args)[1]
                == ref.clustering.vmap_signature(f, args)[1])


# ---------------------------------------------------------------------------
# the pool through Engine -> Falkon
# ---------------------------------------------------------------------------

def test_pool_fuses_bundles_through_the_stack():
    eng, svc, pool = _device_stack(executors=32, max_bundle=32)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 8), dtype=np.float32)
    xs = rng.standard_normal((24, 8), dtype=np.float32)
    futs = [eng.submit(f"t{i}", body, [xs[i], w], vmap_key="b")
            for i in range(24)]
    eng.run()
    svc.shutdown()
    for i, f in enumerate(futs):
        torch.testing.assert_close(
            f.get(), body(torch.from_numpy(xs[i]), torch.from_numpy(w)),
            **PER_TASK)
    assert pool.tasks_run == 24 and pool.fused_tasks == 24
    assert pool.bundles_run < 24 and pool.bundle_stat.peak == 24
    assert pool.run_stat.count == 24
    assert pool.run_stat.total == pytest.approx(pool.device_s)
    assert svc.metrics()["pool"]["fused_tasks"] == 24
    assert pool.metrics()["device"] == "cpu"


def test_mixed_signatures_form_separate_bundles():
    eng, svc, pool = _device_stack()

    def f(x):
        return x * 2.0

    a = [eng.submit(f"a{i}", f, [np.ones((4,), np.float32)], vmap_key="k")
         for i in range(4)]
    b = [eng.submit(f"b{i}", f, [np.ones((8,), np.float32)], vmap_key="k")
         for i in range(4)]
    eng.run()
    svc.shutdown()
    assert all(x.get().shape == (4,) for x in a)
    assert all(x.get().shape == (8,) for x in b)
    assert pool.bundles_run == 2 and pool.fused_tasks == 8


def test_max_bundle_caps_fuse_width():
    eng, svc, pool = _device_stack(executors=32, max_bundle=4)
    futs = [eng.submit(f"t{i}", body, [np.ones((4,), np.float32),
                                       np.ones((4, 4), np.float32)],
                       vmap_key="b") for i in range(12)]
    eng.run()
    svc.shutdown()
    assert all(f.resolved for f in futs)
    assert pool.bundle_stat.peak <= 4 and pool.bundles_run >= 3


def test_non_batchable_tasks_run_as_measured_singletons_on_the_device():
    eng, svc, pool = _device_stack(executors=4)
    futs = [eng.submit(f"p{i}", lambda i=i: i * 10) for i in range(3)]
    arr = eng.submit("np", lambda x: (type(x), x.device.type),
                     [np.ones((2,), np.float32)])
    eng.run()
    svc.shutdown()
    assert [f.get() for f in futs] == [0, 10, 20]
    assert arr.get() == (torch.Tensor, "cpu")
    assert pool.tasks_run == 4 and pool.fused_tasks == 0
    assert pool.run_stat.count == 4 and pool.bundle_stat.peak == 1


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_mixed_bundle_and_singleton_outputs_fuse_downstream(request, device):
    if device == "cuda":
        request.getfixturevalue("cuda")
    eng, svc, pool = bench.device_stack(RealClock(), 16, 16, device)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((8, 8), dtype=np.float32)
    xs = rng.standard_normal((5, 8), dtype=np.float32)
    # stage 1: four tasks fuse into one bundle, the fifth runs alone
    first = [eng.submit(f"a{i}", body, [xs[i], w], vmap_key="b")
             for i in range(4)]
    first.append(eng.submit("a4", body, [xs[4], w]))
    eng.run()
    assert pool.fused_tasks == 4
    outs = [f.get() for f in first]
    assert all(o.device.type == "cpu" for o in outs)
    # stage 2 is fed by both kinds of output: one signature, one bundle
    bundles = pool.bundles_run
    second = [eng.submit(f"b{i}", body, [o, w], vmap_key="b")
              for i, o in enumerate(outs)]
    eng.run()
    svc.shutdown()
    assert pool.bundles_run == bundles + 1 and pool.fused_tasks == 9
    for o, f in zip(outs, second):
        torch.testing.assert_close(f.get(), body(o, torch.from_numpy(w)),
                                   **PER_TASK)


def test_fault_check_fails_one_task_not_the_bundle():
    clock = RealClock()
    pool = DeviceExecutorPool(clock, max_bundle=16, device="cpu")
    cfg = FalkonConfig(drp=DRPConfig(min_executors=8, max_executors=8,
                                     alloc_latency=0.0, alloc_chunk=8))
    svc = FalkonService(clock, cfg, pool=pool)
    svc.provision(8)
    inj = FaultInjector().fail_first_n("t2", 1)
    eng = Engine(clock, fault_injector=inj,
                 retry_policy=RetryPolicy(max_retries=0))
    eng.add_site("dev", FalkonProvider(svc), capacity=8)
    futs = [eng.submit(f"t{i}", body, [np.ones((4,), np.float32) * i,
                                       np.ones((4, 4), np.float32)],
                       vmap_key="b") for i in range(6)]
    eng.run()
    svc.shutdown()
    for i, f in enumerate(futs):
        if i == 2:
            with pytest.raises(TaskFailure):
                f.get()
        else:
            assert f.resolved
    assert pool.fused_tasks == 5


def test_error_outside_the_bodies_fails_the_bundle_and_run_returns(
        monkeypatch):
    """An error that escapes `execute_bundle` (on the card: a CUDA error at
    the stream's synchronize) fails that bundle's tasks; the dispatcher
    lives on and `run()` returns."""
    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(devicepool, "execute_bundle", broken)
    clock = RealClock()
    pool = DeviceExecutorPool(clock, max_bundle=4, device="cpu")
    cfg = FalkonConfig(drp=DRPConfig(min_executors=4, max_executors=4,
                                     alloc_latency=0.0, alloc_chunk=4))
    svc = FalkonService(clock, cfg, pool=pool)
    svc.provision(4)
    eng = Engine(clock, retry_policy=RetryPolicy(max_retries=0))
    eng.add_site("dev", FalkonProvider(svc), capacity=4)
    futs = [eng.submit(f"t{i}", body, [np.ones((4,), np.float32),
                                       np.ones((4, 4), np.float32)],
                       vmap_key="b") for i in range(8)]
    eng.run()
    assert all(t.is_alive() for t in pool._threads)
    svc.shutdown()
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.get()
    assert pool.tasks_run == 8 and pool.fused_tasks == 0


def test_many_dispatchers_keep_every_completion():
    """More dispatcher threads than the bundles need, a short switch
    interval: every task completes once, with its own result."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng, svc, pool = _device_stack(executors=64, max_bundle=4,
                                       dispatchers=max(4, os.cpu_count() or 1))
        xs = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)

        def double(x):
            return x * 2.0

        futs = [eng.submit(f"t{i}", double, [xs[i]], vmap_key="s")
                for i in range(64)]
        eng.run()
        svc.shutdown()
    finally:
        sys.setswitchinterval(old)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.get().numpy(), xs[i] * 2.0)
    assert pool.tasks_run == 64 and pool.fused_tasks == 64
    assert pool.bundles_run == 16


def test_real_staging_composes_with_bundling():
    store = SharedStore()
    payloads = {f"in{i}": np.full((16,), float(i), np.float32)
                for i in range(8)}
    objs = {name: store.put(name, arr.tobytes())
            for name, arr in payloads.items()}
    dl = DataLayer(store, cache_capacity=1e6)
    eng, svc, pool = _device_stack(executors=8, max_bundle=8, data_layer=dl)
    futs = [eng.submit(f"t{i}", body,
                       [payloads[f"in{i}"], np.eye(16, dtype=np.float32)],
                       vmap_key="b", inputs=(objs[f"in{i}"],))
            for i in range(8)]
    eng.run()
    svc.shutdown()
    assert all(f.resolved for f in futs)
    assert pool.io_stat.count == 8 and pool.io_stat.total > 0.0
    assert pool.fused_tasks > 0


def test_foreach_window_streams_through_device_pool():
    eng, svc, pool = _device_stack(executors=8, max_bundle=8)
    wf = Workflow("stream", eng)
    step = wf.atomic(lambda x: torch.sum(x * 2.0), name="step", vmap_key="s")
    total = wf.foreach((np.full((4,), i, np.float32) for i in range(40)),
                       step, window=16,
                       reduce=lambda acc, v: acc + float(v), init=0.0)
    eng.run()
    svc.shutdown()
    assert total.get() == pytest.approx(sum(8.0 * i for i in range(40)))
    assert pool.tasks_run == 40 and pool.fused_tasks > 0


def test_drp_autoscaling_composes_with_device_pool():
    clock = RealClock()
    pool = DeviceExecutorPool(clock, max_bundle=8, device="cpu")
    cfg = FalkonConfig(drp=DRPConfig(max_executors=8, alloc_latency=0.01,
                                     alloc_chunk=4))
    svc = FalkonService(clock, cfg, pool=pool)
    eng = Engine(clock)
    eng.add_site("dev", FalkonProvider(svc), capacity=8)
    futs = [eng.submit(f"t{i}", body, [np.ones((4,), np.float32),
                                       np.ones((4, 4), np.float32)],
                       vmap_key="b") for i in range(16)]
    eng.run()
    assert pool.size() == 1
    svc.shutdown()
    assert all(f.resolved for f in futs)
    assert len(svc.executors) > 0 and pool.tasks_run == 16


def test_vmap_provider_under_simclock():
    eng = Engine(SimClock())
    prov = VmapClusteringProvider(eng.clock, max_bundle=64, device="cpu")
    eng.add_site("d", prov, capacity=8)
    outs = [eng.submit(f"t{i}", body, [np.ones((4,), np.float32) * i,
                                       np.ones((4, 4), np.float32)],
                       vmap_key="s") for i in range(6)]
    solo = eng.submit("solo", body, [np.ones((3,), np.float32),
                                     np.ones((3, 3), np.float32)],
                      vmap_key="s")
    eng.run()
    assert all(o.resolved for o in outs) and solo.resolved
    assert prov.fused_tasks == 6 and prov.run_stat.count == 7
    assert prov.metrics()["bundles"] == 2


def test_vmap_provider_runs_non_batchable_tasks_on_its_device():
    seen = []

    def probe(x):
        seen.append((type(x), x.device.type))
        return x + 1

    eng = Engine(SimClock())
    prov = VmapClusteringProvider(eng.clock, device="cpu")
    eng.add_site("d", prov, capacity=2)
    out = eng.submit("p", probe, [np.ones((3,), np.float32)])
    eng.run()
    assert seen == [(torch.Tensor, "cpu")]
    torch.testing.assert_close(out.get(), torch.full((3,), 2.0))
    assert prov.fused_tasks == 0 and prov.run_stat.count == 1


# ---------------------------------------------------------------------------
# the duration predictor
# ---------------------------------------------------------------------------

def test_matmul_task_cost_matches_hand_computation():
    d = 64
    c = DurationPredictor().predict_cost(
        matmul_task, [np.ones((d,), np.float32), np.ones((d, d), np.float32)])
    assert c.flops == pytest.approx(2 * d * d, rel=0.05)
    assert c.bytes == pytest.approx(4 * d * d, rel=0.2)


def test_attention_task_cost_matches_hand_computation():
    H, S, D = 2, 32, 16
    q = np.ones((H, S, D), np.float32)
    c = DurationPredictor().predict_cost(attention_task, [q, q, q])
    core = 4 * H * S * S * D
    assert core <= c.flops <= 1.5 * core


def test_prediction_cache_hits_by_signature():
    pred = DurationPredictor(device=DeviceModel())
    a = [np.ones((16,), np.float32), np.ones((16, 16), np.float32)]
    b = [np.zeros((16,), np.float32), np.ones((16, 16), np.float32)]
    d1 = pred.predict_duration(matmul_task, a)
    assert pred.predict_duration(matmul_task, b) == d1
    assert d1 >= pred.device.launch_overhead
    assert pred.compiles == 1 and pred.hits == 1
    pred.predict_duration(matmul_task, [np.ones((32,), np.float32),
                                        np.ones((32, 32), np.float32)])
    assert pred.compiles == 2


@pytest.mark.parametrize("untraceable, args", [
    (lambda xs: sorted(xs), [[3, 1, 2]]),
    (lambda x: x.sum().item(), [np.ones((4,), np.float32)]),
    (lambda x: np.asarray(x) + 1, [np.ones((4,), np.float32)])],
    ids=["sorted", "item", "numpy"])
def test_predictor_caches_untraceable_bodies_as_none(untraceable, args):
    pred = DurationPredictor()
    assert pred.predict_duration(untraceable, args) is None
    assert pred.predict_duration(untraceable, args) is None
    assert pred.compiles == 1 and pred.hits == 1


def test_predictor_touches_no_data():
    """A tensor argument is priced from its shape and dtype alone."""
    x = torch.ones(4, 8)
    c = DurationPredictor().predict_cost(lambda t: t @ t.T, [x.to("meta")])
    assert c.flops == 2 * 4 * 4 * 8


def test_predictor_ranks_task_sizes_as_the_reference(ref):
    sizes = (16, 64, 256)

    def durations(pred, fn):
        return [pred.predict_duration(fn, [np.ones((d,), np.float32),
                                           np.ones((d, d), np.float32)])
                for d in sizes]

    t = durations(DurationPredictor(), matmul_task)
    j = durations(ref.hlo_cost.DurationPredictor(), ref.ops.matmul_task)
    assert np.argsort(t).tolist() == np.argsort(j).tolist() == [0, 1, 2]


def test_predictor_fills_task_duration_via_engine():
    pred = DurationPredictor(device=DeviceModel(launch_overhead=0.25))
    eng = Engine(SimClock(), duration_predictor=pred)
    eng.local_site(concurrency=1)
    futs = [eng.submit(f"t{i}", body, [torch.ones(8), torch.ones(8, 8)])
            for i in range(4)]
    eng.run()
    assert all(f.resolved for f in futs)
    assert pred.compiles == 1 and pred.hits == 3
    assert eng.clock.now() >= 4 * 0.25


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------

def test_benchmark_run_fuses_every_task_above_bundle_one():
    out = bench.run(256, "cpu", reps=1)
    rows = {r["bundle"]: r for r in out["sweep"]}
    assert sorted(rows) == bench.BUNDLE_SIZES
    for b, r in rows.items():
        assert r["tasks_run"] == 256
        assert r["fused_tasks"] == (0 if b == 1 else 256)
        assert r["bundles_run"] == 256 // b
    outs = torch.stack(rows[256]["outputs"])
    assert outs.shape == (256, bench.ROWS) and torch.isfinite(outs).all()
    torch.testing.assert_close(torch.stack(rows[1]["outputs"]), outs,
                               **PER_TASK)
    assert out["predicted_task_s"] > 0
    assert set(out["targets_held"]) == {"speedup", "device_frac"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PORT_BODIES))
def test_bundle_on_the_card_matches_the_cpu(cuda, name):
    fn = PORT_BODIES[name]
    args = _body_inputs(name, 16, seed=2)
    c_res, _, c_fused = execute_bundle(fn, _tasks(fn, args), {}, "cpu")
    g_res, _, g_fused = execute_bundle(fn, _tasks(fn, args), {}, cuda)
    assert c_fused == g_fused == 16
    for (_, cv, _), (_, gv, _) in zip(c_res, g_res):
        assert gv.device.type == "cpu"          # brought back to the host
        torch.testing.assert_close(gv, cv, **PER_TASK)


@pytest.mark.cuda
def test_singletons_run_on_the_card(cuda):
    seen = []

    def probe(x):
        seen.append(x.device.type)
        return x * 2

    res, _, fused = execute_bundle(
        probe, _tasks(probe, [[np.ones((3,), np.float32)]]), {}, cuda)
    # brought back to the host, as a fused bundle's outputs are
    assert fused == 0 and seen == ["cuda"] and res[0][1].device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("dispatchers", [1, 2])
def test_pool_on_the_card(cuda, dispatchers):
    xs, w = bench.make_inputs(512, seed=3)
    eng, svc, pool = bench.device_stack(RealClock(), 512, 64, cuda,
                                        dispatchers=dispatchers)
    futs = [eng.submit(f"t{i}", bench.small_task, [xs[i], w], vmap_key="mm")
            for i in range(512)]
    eng.run()
    svc.shutdown()
    assert pool.tasks_run == 512 and pool.fused_tasks == 512
    assert len(pool._streams) == dispatchers
    for i in range(0, 512, 37):
        torch.testing.assert_close(
            futs[i].get(),
            bench.small_task(torch.from_numpy(xs[i]), torch.from_numpy(w)),
            **PER_TASK)
