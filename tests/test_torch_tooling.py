"""The port's tooling against the JAX package's.

- `compress_with_feedback`, int8 and top-k, on the same numpy gradients
  over 5 steps: `q` and `idx` equal, scales, values, residuals and the
  decompressed gradients at 1e-6; `compressed_bytes` equal; and the
  reference's quadratic trained through compressed gradients on the
  port's AdamW;
- `ElasticPolicy.decide` equal over a hypothesis grid, and `reshard_tree`
  from a 2-wide to a 4-wide data-parallel mesh in 4 gloo processes on the
  CPU (`tests/test_distributed.py`'s case): the values survive;
- `op_cost.analyze` against the reference's `hlo_cost.analyze` of the same
  programs (`tests/test_hlo_cost.py`): a 512^3 matmul, a 16-step and a 4 x 4
  nested loop (within 2% of the scans), elementwise bytes at twice the
  size, and an all-reduce's wire bytes on a fake world of 8 against the
  reference's on 8 host devices;
- `perf_debug.report` lists the collectives of two small sharded FFNs.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.distributed import elastic as telastic  # noqa: E402
from repro_torch.launch import op_cost, perf_debug  # noqa: E402
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world, make_mesh  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"a": (64, 33), "b": {"c": (257,), "d": (8, 4, 5)}, "e": [(300,)]}


@contextlib.contextmanager
def fake_world(n: int):
    init_fake_world(n)
    try:
        yield
    finally:
        destroy_fake_world()


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_with_feedback_matches_reference(scheme):
    import jax.numpy as jnp
    from repro.optim import compression as rcomp

    rng = np.random.default_rng(0)
    shape_leaves = tree_leaves(SHAPES, is_leaf=lambda x: isinstance(x, tuple))

    def draw():
        it = iter([rng.standard_normal(s).astype(np.float32) * 3 for s in shape_leaves])
        return tree_map(lambda s: next(it), SHAPES, is_leaf=lambda x: isinstance(x, tuple))

    g0 = draw()
    r_res = rcomp.init_residual(tree_map(jnp.asarray, g0))
    t_res = tcomp.init_residual(tree_map(torch.from_numpy, g0))
    for _ in range(5):
        g = draw()
        rc, r_res, rd = rcomp.compress_with_feedback(tree_map(jnp.asarray, g), r_res,
                                                     scheme=scheme, topk_frac=0.05)
        tc, t_res, td = tcomp.compress_with_feedback(tree_map(torch.from_numpy, g), t_res,
                                                     scheme=scheme, topk_frac=0.05)
        assert len(tc) == len(rc) == len(shape_leaves)
        for (r0, r1), (t0, t1) in zip(rc, tc):
            if scheme == "int8":        # (q, scale)
                assert t0.dtype == torch.int8
                np.testing.assert_array_equal(t0.numpy(), np.asarray(r0))
                np.testing.assert_allclose(t1.numpy(), np.asarray(r1), **F32)
            else:                       # (vals, idx)
                assert t1.dtype == torch.int32
                np.testing.assert_array_equal(t1.numpy(), np.asarray(r1))
                np.testing.assert_allclose(t0.numpy(), np.asarray(r0), **F32)
        for a, b in zip(tree_leaves(t_res), tree_leaves(r_res)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
        for a, b in zip(tree_leaves(td), tree_leaves(rd)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
        assert tcomp.compressed_bytes(tc) == rcomp.compressed_bytes(rc)


def test_residual_is_the_compression_error():
    g = {"w": torch.randn(1000, generator=torch.Generator().manual_seed(1)) * 10}
    for scheme in ("int8", "topk"):
        r = tcomp.init_residual(g)
        _, new_r, deq = tcomp.compress_with_feedback(g, r, scheme=scheme, topk_frac=0.1)
        torch.testing.assert_close(deq["w"] + new_r["w"], g["w"] + r["w"], rtol=0, atol=1e-5)
    comp, _, _ = tcomp.compress_with_feedback({"w": torch.ones(1024)},
                                              tcomp.init_residual({"w": torch.ones(1024)}))
    assert tcomp.compressed_bytes(comp) < 1024 * 4 / 3
    with pytest.raises(ValueError):
        tcomp.compress_with_feedback(g, tcomp.init_residual(g), scheme="fp8")


def test_grad_compression_in_training_loop():
    """`tests/test_distributed.py`'s quadratic: error-feedback int8 gradients
    still drive the port's AdamW to the target."""
    hp = tadamw.Hyper(lr=0.05, warmup=0, weight_decay=0.0, clip=1e9,
                      total_steps=300, min_lr_frac=1.0)
    params = {"w": torch.tensor([4.0, -2.0, 7.0])}
    opt = tadamw.init(params)
    target = torch.tensor([1.0, 2.0, 3.0])
    residual = tcomp.init_residual(params)
    for step in range(300):
        grads = {"w": params["w"] - target}
        _, residual, grads = tcomp.compress_with_feedback(grads, residual, scheme="int8")
        params, opt = tadamw.update(grads, opt, params, step, hp)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


# ---------------------------------------------------------------------------
# elastic data parallelism
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(min_dp=st.integers(1, 8), span=st.integers(0, 64), dp=st.integers(1, 96),
       backlog=st.floats(0, 1e3), step_time=st.floats(0, 10))
def test_elastic_policy_equal(min_dp, span, dp, backlog, step_time):
    from repro.distributed.elastic import ElasticPolicy as RPolicy
    kw = dict(min_dp=min_dp, max_dp=min_dp + span)
    assert telastic.ElasticPolicy(**kw).decide(dp, backlog, step_time) == \
        RPolicy(**kw).decide(dp, backlog, step_time)


_RESHARD = """
import sys
import torch, torch.distributed as dist
from repro_torch.distributed.elastic import make_mesh_for_dp, reshard_tree
from repro_torch.models.params import ParamDesc
rank = int(sys.argv[1])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[2], 4), rank=rank, world_size=4)
descs = {"w": ParamDesc((8, 16), ("batch", None)), "b": ParamDesc((16,), (None,))}
tree = {"w": torch.arange(128, dtype=torch.float32).reshape(8, 16), "b": torch.ones(16)}
t2 = reshard_tree(tree, descs, make_mesh_for_dp(2, device_type="cpu"))
t4 = reshard_tree(t2, descs, make_mesh_for_dp(4, device_type="cpu"))
assert tuple(t4["w"].to_local().shape) == (2, 16), t4["w"].to_local().shape
assert torch.equal(t4["w"].full_tensor(), tree["w"])
assert torch.equal(t4["b"].full_tensor(), tree["b"])
print("OK", rank, t4["w"].placements)
dist.destroy_process_group()
"""


_GATHER_LAST = """
import sys
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.distributed.sharding import AxisRules, gather_last, use_axis_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import default_rules
rank = int(sys.argv[1])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[2], 4), rank=rank, world_size=4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
g = torch.Generator().manual_seed(0)
full = torch.randn(4, 3, 8, generator=g)
idx = torch.randint(0, 8, (4, 3, 1), generator=g)
x = distribute_tensor(full.clone().requires_grad_(True), mesh, [Shard(0), Shard(2)])
with use_axis_rules(AxisRules(default_rules(), mesh)):
    out = gather_last(x, distribute_tensor(idx, mesh, [Shard(0), Replicate()]))
assert list(out.placements) == [Shard(0), Replicate()], out.placements
assert torch.equal(out.full_tensor(), torch.gather(full, -1, idx))
out.sum().backward()
want = torch.zeros_like(full).scatter_(-1, idx, 1.0)
assert torch.equal(x.grad.full_tensor(), want)
print("OK", rank)
dist.destroy_process_group()
"""


def _gloo4(script, tmp_path, timeout: float = 60) -> list[tuple[str, str]]:
    """(stdout, stderr) of `script` run as each of 4 gloo ranks, one
    intra-op thread each."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(tmp_path / "store")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    return outs


def test_reshard_tree_dp2_to_dp4(tmp_path):
    for r, (out, err) in enumerate(_gloo4(_RESHARD, tmp_path)):
        assert f"OK {r} (Shard(dim=0), Replicate())" in out, err[-2000:]


def test_gather_last_picks_across_vocab_shards(tmp_path):
    """The loss's label pick on a row sharded along its last dim, on a 2 x 2
    gloo mesh under active rules: the values and the gradient of
    ``torch.gather`` on the whole tensor."""
    for r, (out, err) in enumerate(_gloo4(_GATHER_LAST, tmp_path)):
        assert f"OK {r}" in out, err[-2000:]


def test_make_mesh_for_dp_needs_the_ranks():
    with fake_world(2), pytest.raises(ValueError, match="need 4 ranks"):
        telastic.make_mesh_for_dp(4, device_type="cpu")


# ---------------------------------------------------------------------------
# op_cost.analyze against the reference's HLO walk
# ---------------------------------------------------------------------------

def _ref_analyze(fn, *shapes):
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_cost import analyze
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze(jax.jit(fn).lower(*args).compile().as_text())


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


def _loop(x, w, n):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


def test_analyze_single_matmul():
    import jax.numpy as jnp  # noqa: F401
    c = op_cost.analyze(lambda a, b: a @ b, *_meta((512, 512), (512, 512)))
    assert c.flops == 2 * 512 ** 3
    assert c.flops == pytest.approx(_ref_analyze(lambda a, b: a @ b, (512, 512), (512, 512)).flops,
                                    rel=0.01)


def test_analyze_unrolled_loops_match_the_scans():
    import jax

    def scan16(x, w):
        return jax.lax.scan(lambda c, _: (jax.numpy.tanh(c @ w), None), x, None, length=16)[0]

    def nested(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda c2, _: (jax.numpy.tanh(c2 @ w), None),
                                c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=4)[0]

    def nested_t(x, w):
        for _ in range(4):
            x = _loop(x, w, 4)
        return x

    sh = ((512, 512), (512, 512))
    for t_fn, r_fn in ((lambda x, w: _loop(x, w, 16), scan16), (nested_t, nested)):
        c = op_cost.analyze(t_fn, *_meta(*sh))
        assert c.flops == pytest.approx(16 * 2 * 512 ** 3, rel=0.02)
        assert c.flops == pytest.approx(_ref_analyze(r_fn, *sh).flops, rel=0.02)


def test_analyze_bytes_scale_with_tensor_size():
    c1 = op_cost.analyze(lambda a, b: a + b, *_meta((1024, 1024), (1024, 1024)))
    c2 = op_cost.analyze(lambda a, b: a + b, *_meta((2048, 1024), (2048, 1024)))
    assert c2.bytes == 2 * c1.bytes
    assert c1.bytes == 3 * 1024 * 1024 * 4        # read 2 operands, write 1
    assert c1.bytes == pytest.approx(
        _ref_analyze(lambda a, b: a + b, (1024, 1024), (1024, 1024)).bytes, rel=0.05)
    assert c1.peak_bytes == 1024 * 1024 * 4       # the one result held


_REF_ALLREDUCE = """
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((8,), ("d",))
x = jax.ShapeDtypeStruct((1024, 1024), jnp.float32, sharding=NamedSharding(mesh, P("d")))
f = jax.jit(lambda a: a.sum(), out_shardings=NamedSharding(mesh, P()))
c = analyze(f.lower(x).compile().as_text())
print("WIRE", c.coll_wire, c.coll_by_kind["all-reduce"]["count"])
"""


def test_analyze_all_reduce_wire_bytes_match_the_reference():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_ALLREDUCE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("WIRE")]
    assert line, out.stderr[-2000:]
    ref_wire, ref_count = float(line[0].split()[1]), float(line[0].split()[2])

    with fake_world(8):
        mesh = make_mesh((8,), ("d",), "cpu")
        x = DTensor.from_local(torch.empty(128, 1024, device="meta"), mesh, [Shard(0)],
                               run_check=False, shape=torch.Size((1024, 1024)),
                               stride=(1024, 1))
        c = op_cost.analyze(lambda a: a.sum().redistribute(mesh, [Replicate()]), x)
    # a scalar f32 all-reduce over 8: 2 * 7/8 * 4 = 7 bytes on the wire
    assert c.coll_wire == ref_wire == 7.0
    assert c.coll_by_kind["all-reduce"]["count"] == ref_count == 1
    assert c.flops == 1024 * 1024 * 4 / 8 / 4     # this rank's 128 rows summed


# ---------------------------------------------------------------------------
# perf_debug
# ---------------------------------------------------------------------------

def test_perf_debug_reports_the_collectives_of_sharded_ffns():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import registry as treg
    from repro_torch.distributed.sharding import AxisRules, use_axis_rules
    from repro_torch.models import layers as L
    from repro_torch.models.params import default_rules

    cfg = treg.reduced(treg.get_config("qwen2-1.5b"))          # d 64, ff 128
    d, ff = cfg.d_model, cfg.d_ff
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")

        def dt(local, pl, shape):
            t = torch.empty(local, device="meta")
            return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride())

        R = Replicate()
        p = {"norm": {"scale": dt((d,), [R, R], (d,))},
             "w1": dt((d, ff // 2), [R, Shard(1)], (d, ff)),
             "w3": dt((d, ff // 2), [R, Shard(1)], (d, ff)),
             "w2": dt((ff // 2, d), [R, Shard(0)], (ff, d))}
        x = dt((2, 8, d), [Shard(0), R], (4, 8, d))
        def two_ffns():
            return L.apply_ffn(cfg, p, L.apply_ffn(cfg, p, x))

        with implicit_replication(), use_axis_rules(AxisRules(default_rules(), mesh)):
            text = perf_debug.report(two_ffns)
            coll, byts = perf_debug.attribute(two_ffns)
    head, hbm = text.split("== top HBM ops ==")
    # the first FFN's partial sums over the model axis are reduced where the
    # second one's norm reads them
    assert "repro_torch/models/layers.py" in head
    assert any(k in head for k in ("all-reduce", "reduce-scatter"))
    assert coll and all(r[0] > 0 and r[1] >= 1 for r in coll)
    assert "mm" in hbm
    assert sum(r[0] for r in byts) > 0


def test_once_per_shape_replays_the_count():
    """A body traced once per shape and replayed counts what running it
    every time counts: FLOPs, bytes and the peak of live bytes."""
    def body(x, w):
        for _ in range(3):
            x = torch.tanh(x @ w)
        return x

    x, w = _meta((64, 64), (64, 64))
    full = op_cost.analyze(lambda: [body(x, w) for _ in range(4)])
    counter = op_cost._OpCounter()
    with counter:
        outs = [counter.once_per_shape(body, x, w) for _ in range(4)]
    once = counter.cost
    del outs
    assert (once.flops, once.bytes, once.peak_bytes) == (full.flops, full.bytes, full.peak_bytes)
    assert full.flops == 4 * 3 * (2 * 64 ** 3 + 64 * 64)
    # with data the body just runs
    xr = torch.ones(4, 4)
    assert torch.equal(op_cost._OpCounter().once_per_shape(body, xr, xr), body(xr, xr))
