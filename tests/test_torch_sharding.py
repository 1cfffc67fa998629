"""The port's sharding rules against the JAX package's.

- `runnable_cells()` holds the same cells in both packages;
- for all ten archs, every leaf of `build_descriptors` and of
  `build_cache_descriptors` at each `SHAPES` cell, resolved with that
  cell's `axis_rules_for` (and, for the optimizer state, `opt_rule_extend`)
  at the 16 x 16 and 2 x 16 x 16 mesh shapes, is the same spec tuple in
  both packages (the reference's `PartitionSpec` read as a tuple);
- the cases and the property of `tests/test_sharding.py`, run through both;
- `placements` maps a spec to one `Shard`/`Replicate` per mesh dim, and
  `constrain` is the identity without active rules;
- the active rules are seen from another thread (a card's backward runs
  on one).

No process group is needed: the meshes are stand-ins that carry only axis
names and sizes.
"""
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.configs import base as rbase  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.models import params as rparams  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
MESH = {"data": 16, "model": 16}


def ref_mesh(names, shape):
    """The stand-in of `tests/test_sharding.py`: axis names and a devices
    array's shape."""
    return type("M", (), {"axis_names": names,
                          "devices": type("D", (), {"shape": shape})()})()


def port_mesh(names, shape):
    return type("M", (), {"mesh_dim_names": names, "shape": shape})()


def _ref_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree, is_leaf=rparams.is_desc)


def _port_leaves(tree):
    return tparams.tree_leaves(tree, is_leaf=tparams.is_desc)


def test_runnable_cells_equal():
    # the same cells, each package listing them in its registry's order
    # (the port lists its archs in the order they were ported)
    assert sorted(tbase.runnable_cells()) == sorted(rbase.runnable_cells())
    assert list(dict.fromkeys(a for a, _ in tbase.runnable_cells())) == treg.ARCH_NAMES
    assert tbase.LONG_CONTEXT_ARCHS == rbase.LONG_CONTEXT_ARCHS
    assert {k: tuple(vars(v).values()) for k, v in tbase.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in rbase.SHAPES.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", rreg.ARCH_NAMES)
def test_every_descriptor_resolves_alike(arch, mesh_name):
    names, shape = MESHES[mesh_name]
    rm, tm = ref_mesh(names, shape), port_mesh(names, shape)
    ms = dict(zip(names, shape))
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    rp, tp = _ref_leaves(RT.build_descriptors(rcfg)), _port_leaves(TT.build_descriptors(tcfg))
    assert [d.shape for d in rp] == [d.shape for d in tp]
    n_checked = 0
    for sname, cell in rbase.SHAPES.items():
        rrules = rspecs.axis_rules_for(rcfg, cell, rm)
        trules = tspecs.axis_rules_for(tcfg, tbase.SHAPES[sname], tm)
        assert trules == rrules
        for rd, td in zip(rp, tp):
            rs = rparams.resolve_spec(rd, rrules, ms)
            ts = tparams.resolve_spec(td, trules, ms)
            assert ts == tuple(rs), (sname, rd.shape, rd.axes)
            ro = rspecs.opt_rule_extend(rs, rd.shape, ms, "data")
            assert tspecs.opt_rule_extend(ts, td.shape, ms, "data") == tuple(ro)
            n_checked += 1
        rc = _ref_leaves(RT.build_cache_descriptors(rcfg, cell.global_batch, cell.seq_len))
        tc = _port_leaves(TT.build_cache_descriptors(tcfg, cell.global_batch, cell.seq_len))
        assert [d.shape for d in rc] == [d.shape for d in tc]
        for rd, td in zip(rc, tc):
            rs = rparams.resolve_spec(rd, rrules, ms)
            assert tparams.resolve_spec(td, trules, ms) == tuple(rs), (sname, rd.axes)
            n_checked += 1
    assert n_checked > 4 * len(rp)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases, through both packages
# ---------------------------------------------------------------------------

def _both(shape, axes, rules=None, mesh=MESH):
    r = rparams.resolve_spec(rparams.ParamDesc(shape, axes),
                             rules or rparams.default_rules(), mesh)
    t = tparams.resolve_spec(tparams.ParamDesc(shape, axes),
                             rules or tparams.default_rules(), mesh)
    assert t == tuple(r)
    return t


@pytest.mark.parametrize("shape, axes, want", [
    ((1024, 2816), ("embed", "ff"), (None, "model")),             # divisible
    ((3584, 28, 128), ("embed", "heads", "head_dim"), ()),         # 28 heads: replicated
    ((16, 160, 64), ("batch", "experts", None), ("data",)),        # data used once
])
def test_resolve_spec_cases(shape, axes, want):
    assert _both(shape, axes) == want


def test_opt_rule_extend_cases():
    spec = _both((5376, 21504), ("embed", "ff"))
    assert tspecs.opt_rule_extend(spec, (5376, 21504), MESH, "data") == ("data", "model")
    assert tspecs.opt_rule_extend(("data", "model"), (160, 1536), MESH, "data") == \
        ("data", "model")


@settings(max_examples=50, deadline=None)
@given(
    dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    axes=st.lists(st.sampled_from(
        ["embed", "ff", "heads", "vocab", "batch", "experts", None]),
        min_size=1, max_size=4),
)
def test_resolve_spec_properties(dims, axes):
    """Both packages agree, and: every sharded dim is divisible by its axis
    size; no mesh axis is used twice; the spec is no longer than the rank."""
    n = min(len(dims), len(axes))
    shape = tuple(dims[:n])
    spec = _both(shape, tuple(axes[:n]))
    assert len(spec) <= n
    used = []
    for dim, part in zip(shape, spec):
        if part is None:
            continue
        names = (part,) if isinstance(part, str) else tuple(part)
        size = 1
        for nm in names:
            size *= MESH[nm]
        assert dim % size == 0
        used.extend(names)
    assert len(used) == len(set(used))


@pytest.mark.parametrize("shape", list(rbase.SHAPES))
def test_axis_rules_per_cell(shape):
    names, sizes = MESHES["16x16"]
    rules = tspecs.axis_rules_for(treg.get_config("gemma3-27b"), tbase.SHAPES[shape],
                                  port_mesh(names, sizes))
    assert rules == rspecs.axis_rules_for(rreg.get_config("gemma3-27b"),
                                          rbase.SHAPES[shape], ref_mesh(names, sizes))
    cell = tbase.SHAPES[shape]
    if cell.kind in ("train", "prefill"):
        assert rules["seq_act"] == "model"
    if cell.kind == "decode":
        assert rules["seq_act"] is None
        assert rules["kv_seq"] == ("data" if shape == "long_500k" else "model")


@settings(max_examples=30, deadline=None)
@given(shape=st.lists(st.integers(1, 64), min_size=1, max_size=4),
       axes=st.lists(st.sampled_from(["batch", "heads", "seq_act", "inner", None]),
                     min_size=4, max_size=4))
def test_axis_rules_spec_equal(shape, axes):
    """`AxisRules.spec`, which `constrain` resolves through, agrees."""
    names, sizes = MESHES["2x16x16"]
    rules = dict(rparams.default_rules(multi_pod=True), seq_act="model")
    r = rsh.AxisRules(rules, ref_mesh(names, sizes)).spec(axes[:len(shape)], shape)
    t = tsh.AxisRules(rules, port_mesh(names, sizes)).spec(axes[:len(shape)], shape)
    assert t == tuple(r)


# ---------------------------------------------------------------------------
# placements and constrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec, names, want", [
    ((), ("data", "model"), [Replicate(), Replicate()]),
    ((None, "model"), ("data", "model"), [Replicate(), Shard(1)]),
    (("data", None, "model"), ("data", "model"), [Shard(0), Shard(2)]),
    ((("pod", "data"), "model"), ("pod", "data", "model"), [Shard(0), Shard(0), Shard(1)]),
    ((None, ("pod", "data")), ("pod", "data", "model"), [Shard(1), Shard(1), Replicate()]),
])
def test_placements(spec, names, want):
    assert tparams.placements(spec, port_mesh(names, (2,) * len(names))) == want


def test_local_shape():
    assert tparams.local_shape((32, 4096, 12), (("pod", "data"), "model"),
                               {"pod": 2, "data": 16, "model": 16}) == (1, 256, 12)


def test_constrain_is_identity_without_rules():
    x = torch.randn(2, 3, 4)
    assert tsh.current_rules() is None
    assert tsh.constrain(x, ("batch", None, "heads")) is x
    y = x.clone()
    tsh.write_row(y, 1, torch.ones(2, 4))
    assert y[:, 1].eq(1).all() and y[:, 0].equal(x[:, 0]) and y[:, 2].equal(x[:, 2])
    idx = torch.tensor([[[1], [0], [3]], [[2], [2], [0]]])
    assert tsh.gather_last(x, idx).equal(torch.gather(x, -1, idx))
    names, sizes = MESHES["16x16"]
    with tsh.use_axis_rules(tsh.AxisRules(tparams.default_rules(), port_mesh(names, sizes))):
        # a plain tensor is never redistributed, even under rules
        assert tsh.constrain(x, ("batch", None, "heads")) is x
    assert tsh.current_rules() is None


def test_spec_and_placement_trees():
    names, sizes = MESHES["16x16"]
    mesh = port_mesh(names, sizes)
    descs = TT.build_descriptors(treg.get_config("qwen2-1.5b"))
    rules = tparams.default_rules()
    specs = tparams.spec_tree(descs, rules, mesh)
    pls = tparams.placement_tree(descs, rules, mesh)
    seen = []

    def check(d, sp, pl):
        assert sp == tparams.resolve_spec(d, rules, dict(zip(names, sizes)))
        assert pl == tparams.placements(sp, mesh)
        seen.append(d)

    tparams.tree_map(check, descs, specs, pls, is_leaf=tparams.is_desc)
    assert len(seen) == len(_port_leaves(descs))
    # the embedding table: vocab over the model axis
    assert specs["embed"]["table"] == ("model",)
    assert pls["embed"]["table"] == [Replicate(), Shard(0)]


def test_axis_rules_reach_other_threads():
    """On a card the autograd engine runs the backward, and with it each
    checkpointed region's recompute, on a thread of its own: the active
    rules are the process's, seen from any thread, so that the recompute
    takes the partitions the forward took."""
    import threading

    rules, seen = object(), []
    with tsh.use_axis_rules(rules):
        t = threading.Thread(target=lambda: seen.append(tsh.current_rules()))
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert seen == [rules]
    assert tsh.current_rules() is None
