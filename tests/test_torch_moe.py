"""The port's MoE FFN and MLA against the JAX package: the MoE layer in both
dispatch modes (with capacity drops), MLA prefill and absorbed decode, and
reduced granite-moe-3b-a800m and deepseek-v2-236b (2 repeats of each layer
group) served end to end and trained one step, on the same numpy weights
(the reference's `init_tree`) and inputs, f32.

Tolerance 1e-4 (rtol = atol): the same math summed in another order over a
few layers.  The MoE layer runs at S = 96, so a group is 48 tokens (two
groups) with 16 slots per expert, and some assignments drop.  The served
prompt is 32 tokens, as long as the reduced `kv_lora`, so that growing the
caches for decode must find MLA's latent cache by name.  Decode against the
port's own prefill is held to 5e-2, as tests/test_decode_consistency.py
holds the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_tree as j_init  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import reference_dict  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (init_tree as t_init, is_desc,  # noqa: E402
                                       params_from_numpy, tree_leaves, tree_map)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v2-236b"
ARCHS = [GRANITE, DEEPSEEK]
B, S, N_DECODE = 2, 32, 4
S_MOE = 96


def _cfgs(arch, **kw):
    """The reduced arch with 2 repeats of each layer group, in both packages."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.smoke_config(arch)
        out.append(dataclasses.replace(cfg, blocks=tuple((p, 2) for p, _ in cfg.blocks), **kw))
    return out


def _with_dispatch(cfg, dispatch):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


def _numpy_tree(descs, seed=0):
    return jax.tree_util.tree_map(np.asarray, j_init(descs, jax.random.PRNGKey(seed)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def _close_trees(got, exp):
    g, e = tree_leaves(got), jax.tree_util.tree_leaves(exp)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert tuple(a.shape) == b.shape
        _close(a, b)


def _grow_ref(caches, cur, total):
    """The reference's cache growth (examples/serve_lm.py::_grow), held to
    the attention caches named in `ATTN_CACHE_KEYS`, as the port's
    `grow_caches` is."""
    def grow(path, x):
        if path[-1].key in tserve.ATTN_CACHE_KEYS and x.shape[2] == cur:
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, total - cur)
            return jnp.pad(x, pad, constant_values=-1 if x.dtype == jnp.int32 else 0)
        return x
    return jax.tree_util.tree_map_with_path(grow, caches)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _drops(cfg, p, x):
    """Dropped (token, k) assignments of the port's routing of `x`, counted
    through its slot helper, group by group as `apply_moe` routes."""
    m = cfg.moe
    h = TL.apply_norm(cfg, p["norm"], x)
    g = min(m.group_size, x.shape[1])
    while x.shape[1] % g:
        g -= 1
    c = TM.capacity(g, m.top_k, m.n_experts, m.capacity_factor)
    n = 0
    for i in range(0, x.shape[1], g):
        _, _, gate_idx = TM.route(cfg, p, h[:, i:i + g])
        slot, keep = TM.slots(gate_idx, m.n_experts, c)
        assert bool((slot[~keep] == m.n_experts * c).all())
        n += int((~keep).sum())
    return n


@pytest.mark.parametrize("dispatch", ["scatter", "index"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dispatch):
    jc, tc = (_with_dispatch(c, dispatch) for c in _cfgs(arch))
    tree = _numpy_tree(JM.moe_descs(jc))
    p = params_from_numpy(tree, "cpu")
    x = _x((B, S_MOE, jc.d_model))
    j_out, j_aux = JM.apply_moe(jc, tree, jnp.asarray(x))
    t_out, t_aux = TM.apply_moe(tc, p, torch.from_numpy(x))
    _close(t_out, j_out)
    _close(t_aux, j_aux)
    assert _drops(tc, p, torch.from_numpy(x)) > 0      # the drop path ran


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_modes_agree(arch):
    """tests/test_models_property.py::test_moe_dispatch_modes_equivalent on
    the port: both modes build the same buffer, so the outputs are equal."""
    _, tc = _cfgs(arch)
    p = params_from_numpy(_numpy_tree(JM.moe_descs(_cfgs(arch)[0])), "cpu")
    x = torch.from_numpy(_x((B, 64, tc.d_model)))
    y0, a0 = TM.apply_moe(_with_dispatch(tc, "scatter"), p, x)
    y1, a1 = TM.apply_moe(_with_dispatch(tc, "index"), p, x)
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
    assert float(a0) == float(a1)


def test_capacity_and_slots_follow_k_slot_major_priority():
    """Every token's first choice is placed before any token's second, and
    an assignment past the capacity goes to the trash slot."""
    assert [TM.capacity(g, 8, 40, 1.25) for g in (1, 683, 2048)] == [4, 172, 512]
    # 3 tokens, K = 2, E = 2, c = 2: expert 0 is every first choice
    gate_idx = torch.tensor([[[0, 1], [0, 1], [0, 1]]])
    slot, keep = TM.slots(gate_idx, 2, 2)
    assert keep.tolist() == [[[True, True, False], [True, True, False]]]
    assert slot.tolist() == [[[0, 1, 4], [2, 3, 4]]]


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_apply_mla_prefill_and_absorbed_decode_match_reference():
    jc, tc = _cfgs(DEEPSEEK)
    tree = _numpy_tree(JA.mla_descs(jc))
    p = params_from_numpy(tree, "cpu")
    x = _x((B, S + N_DECODE, jc.d_model))
    j_out, j_cache = JA.apply_mla(jc, tree, jnp.asarray(x[:, :S]), mode="prefill")
    t_out, t_cache = TA.apply_mla(tc, p, torch.from_numpy(x[:, :S]), mode="prefill")
    _close(t_out, j_out)
    assert sorted(t_cache) == ["c_kv", "k_rope"]
    for k in j_cache:
        _close(t_cache[k], j_cache[k])
    j_cache = {k: jnp.pad(v, ((0, 0), (0, N_DECODE), (0, 0))) for k, v in j_cache.items()}
    t_cache = {k: torch.nn.functional.pad(v, (0, 0, 0, N_DECODE)) for k, v in t_cache.items()}
    for t in range(S, S + N_DECODE):
        j_out, j_cache = JA.apply_mla(jc, tree, jnp.asarray(x[:, t:t + 1]), mode="decode",
                                      cache=j_cache, pos_t=t)
        t_out, t_cache = TA.apply_mla(tc, p, torch.from_numpy(x[:, t:t + 1]), mode="decode",
                                      cache=t_cache, pos_t=t)
        _close(t_out, j_out)
    for k in j_cache:
        _close(t_cache[k], j_cache[k])


def test_mla_train_mode_with_use_pallas_runs_the_plain_path():
    """MLA never reaches the kernel (nor does the reference's), so
    `use_pallas` in train mode does not raise and changes nothing."""
    _, tc = _cfgs(DEEPSEEK)
    p = params_from_numpy(_numpy_tree(JA.mla_descs(_cfgs(DEEPSEEK)[0])), "cpu")
    x = torch.from_numpy(_x((B, S, tc.d_model)))
    out, cache = TA.apply_mla(dataclasses.replace(tc, use_pallas=True), p, x, mode="train")
    exp, _ = TA.apply_mla(tc, p, x, mode="train")
    assert cache is None
    torch.testing.assert_close(out, exp, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the reduced models served end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, _ = _cfgs(request.param)
    tree = _numpy_tree(JT.build_descriptors(jc))
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    return request.param, tree, params_from_numpy(tree, "cpu"), toks


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(model, use_pallas):
    """Prefill logits and caches, then N_DECODE decode steps' logits and the
    caches after them.  granite's prefill with `use_pallas` takes the flash
    wrapper (its plain version on the CPU; the reference's Pallas kernel in
    interpret mode); deepseek's MLA takes neither."""
    arch, tree, params, toks = model
    jc, tc = _cfgs(arch, use_pallas=use_pallas)
    j_logits, j_caches = JT.prefill(jc, tree, jnp.asarray(toks[:, :S]))
    t_logits, t_caches = TT.prefill(tc, params, torch.from_numpy(toks[:, :S]))
    _close(t_logits, j_logits)
    _close_trees(t_caches, j_caches)
    j_caches = _grow_ref(j_caches, S, S + N_DECODE)
    t_caches = tserve.grow_caches(t_caches, S, S + N_DECODE)
    for i in range(N_DECODE):
        tok = toks[:, S + i:S + i + 1]
        j_logits, j_caches = JT.decode_step(jc, tree, j_caches, jnp.asarray(tok),
                                            jnp.asarray(S + i, jnp.int32))
        t_logits, t_caches = TT.decode_step(tc, params, t_caches, torch.from_numpy(tok), S + i)
        _close(t_logits, j_logits)
    _close_trees(t_caches, j_caches)


def test_greedy_tokens_equal_reference(model):
    arch, tree, params, toks = model
    jc, tc = _cfgs(arch, use_pallas=True)
    j_logits, j_caches = jsteps.make_prefill_step(jc)(tree, {"tokens": jnp.asarray(toks[:, :S])})
    j_caches = _grow_ref(j_caches, S, S + N_DECODE)
    j_tok = jnp.argmax(j_logits[:, -1], -1).astype(jnp.int32)[:, None]
    j_step, j_out = jsteps.make_serve_step(jc), [j_tok]
    for i in range(N_DECODE - 1):
        j_tok, j_caches = j_step(tree, j_caches, j_tok, jnp.asarray(S + i, jnp.int32))
        j_out.append(j_tok)
    res = tserve.serve(tc, batch=B, prompt_len=S, new_tokens=N_DECODE, device="cpu",
                       params=params, prompts=torch.from_numpy(toks[:, :S]))
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(j_out, 1))


def test_port_decode_matches_its_prefill(model):
    """Prefill S - 1 tokens and decode token S - 1 == prefill S tokens, at
    the reference's decode-consistency tolerance (5e-2)."""
    arch, _, params, toks = model
    _, tc = _cfgs(arch)
    m = TT.Transformer(tc, params)
    _, caches = m.prefill(torch.from_numpy(toks[:, :S - 1]))
    caches = tserve.grow_caches(caches, S - 1, S)
    logits_d, _ = m.decode_step(caches, torch.from_numpy(toks[:, S - 1:S]), S - 1)
    logits_f, _ = m.prefill(torch.from_numpy(toks[:, :S]))
    _close(logits_d, logits_f.numpy(), dict(rtol=5e-2, atol=5e-2))


def test_grow_caches_grows_the_latent_cache_by_name(model):
    """A prompt as long as `kv_lora` (32): `c_kv` is (reps, B, 32, 32), and
    only its sequence dim grows, as does `k_rope`'s (and granite's k, v)."""
    arch, _, params, toks = model
    _, tc = _cfgs(arch)
    _, caches = TT.prefill(tc, params, torch.from_numpy(toks[:, :S]))
    grown = tserve.grow_caches(caches, S, S + 3)
    for g in range(len(tc.blocks)):
        before, after = caches[g]["l0"]["mixer"], grown[g]["l0"]["mixer"]
        keys = ("c_kv", "k_rope") if arch == DEEPSEEK else ("k", "v")
        assert sorted(after) == sorted(keys)
        for key in keys:
            assert tuple(after[key].shape) == \
                tuple(before[key].shape[:2]) + (S + 3,) + tuple(before[key].shape[3:])
            assert bool((after[key][:, :, S:] == 0).all())
            torch.testing.assert_close(after[key][:, :, :S], before[key], rtol=0, atol=0)
        if arch == DEEPSEEK:
            assert before["c_kv"].shape[2:] == (S, tc.mla_kv_lora) == (32, 32)


def test_init_cache_matches_reference(model):
    arch, *_ = model
    jc, tc = _cfgs(arch)
    exp = JT.init_cache(jc, B, 16)
    got = TT.init_cache(tc, B, 16, "cpu")
    assert [str(t.dtype).split(".")[-1] for t in tree_leaves(got)] == \
        [str(a.dtype) for a in jax.tree_util.tree_leaves(exp)]
    _close_trees(got, exp)


def test_drawn_weights_keep_router_and_norm_scales_f32(model):
    """Under bf16 compute the router and the norm scales (read in f32 by the
    reference) stay f32; every other leaf, MLA's latent norms included (read
    in the compute dtype), is stored in bf16."""
    arch, tree, *_ = model
    _, tc = _cfgs(arch, compute_dtype="bfloat16")
    descs = TT.build_descriptors(tc)
    params = t_init(descs, torch.Generator().manual_seed(0), "cpu", dtype=torch.bfloat16)
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [a.shape for a in jax.tree_util.tree_leaves(tree)]
    leaves = tree_leaves(descs, is_leaf=is_desc)
    assert [t.dtype for t in tree_leaves(params)] == \
        [torch.float32 if d.f32 else torch.bfloat16 for d in leaves]
    moe = params["blocks"][-1]["l0"]["moe"]
    assert moe["router"].dtype == moe["norm"]["scale"].dtype == torch.float32
    assert moe["w1"].dtype == torch.bfloat16
    if arch == DEEPSEEK:
        mixer = params["blocks"][0]["l0"]["mixer"]
        assert mixer["q_norm"].dtype == mixer["kv_norm"].dtype == torch.bfloat16
        assert mixer["norm"]["scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 64


def _batch(cfg, step=0):
    from repro.data import pipeline as jdata
    return jdata.SyntheticLM(cfg, jdata.DataConfig(seed=5, global_batch=TRAIN_B,
                                                   seq_len=TRAIN_S)).batch(step)


def test_forward_train_loss_aux_and_grads_match_reference(model):
    arch, tree, *_ = model
    jc, tc = _cfgs(arch)
    batch = _batch(jc)
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.forward_train(jc, p, b), has_aux=True))
    (j_loss, j_m), j_grads = fn(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    t_loss, t_m = TT.forward_train(tc, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    t_grads = torch.autograd.grad(t_loss, tree_leaves(params))
    _close(t_loss, j_loss)
    _close(t_m["ce"], j_m["ce"])
    _close(t_m["aux"], j_m["aux"])
    assert float(t_m["aux"].detach()) > 0
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(t_grads) == len(j_leaves)
    for g, e in zip(t_grads, j_leaves):
        assert tuple(g.shape) == e.shape
        _close(g, e)


def test_train_step_matches_reference(model):
    """One step, 2 microbatches, remat `nothing_saveable` (which replays the
    routing in the backward): metrics, then the params and AdamW moments."""
    arch, tree, *_ = model
    jc, tc = _cfgs(arch)
    kw = dict(lr=3e-4, warmup=2, total_steps=3, microbatches=2)
    batch = _batch(jc)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    jo, to = jadamw.init(jp), tadamw.init(tp)
    jp, jo, jm = jax.jit(jsteps.make_train_step(jc, jadamw.Hyper(**kw)))(
        jp, jo, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0, jnp.int32))
    tp, to, tm = tsteps.make_train_step(tc, tadamw.Hyper(**kw))(
        tp, to, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    for k in jm:
        _close(tm[k], jm[k])
    _close_trees(tp, jp)
    _close_trees(to, jo)


# ---------------------------------------------------------------------------
# configs, depth cut, model FLOPs
# ---------------------------------------------------------------------------

def test_configs_and_counts_match_reference():
    for arch in ARCHS:
        jc, tc = jreg.get_config(arch), treg.get_config(arch)
        assert dataclasses.asdict(jc) == reference_dict(tc), arch
        assert jc.param_count() == tc.param_count()
        assert jc.active_param_count() == tc.active_param_count()
    assert treg.get_config(GRANITE).head_dim == 64


def test_cut_depth_keeps_widths_and_the_layer_kinds():
    cfg = treg.get_config(DEEPSEEK)
    cut = treg.cut_depth(cfg, 4)
    assert [r for _, r in cut.blocks] == [1, 4] and cut.n_layers == 5
    assert dataclasses.replace(cut, blocks=cfg.blocks) == cfg
    assert treg.cut_depth(treg.get_config(GRANITE), 64) == treg.get_config(GRANITE)
    with pytest.raises(ValueError):
        treg.cut_depth(cfg, 0)


def test_served_config_refuses_weights_larger_than_the_card():
    """deepseek-v2-236b at full depth needs 471 GB of bf16 weights; cut to
    1 dense + 4 MoE layers it needs 34.6 GB and fits an 80 GB card."""
    full = tserve.weight_bytes(treg.get_config(DEEPSEEK))
    assert 4.7e11 < full < 4.72e11
    with pytest.raises(ValueError, match="--max-repeats"):
        tserve.served_config(DEEPSEEK, capacity_bytes=80 * 10**9)
    cfg = tserve.served_config(DEEPSEEK, 4, capacity_bytes=80 * 10**9)
    assert cfg.use_pallas and cfg.n_layers == 5
    assert 3.45e10 < tserve.weight_bytes(cfg) < 3.47e10
    assert tserve.served_config(GRANITE, capacity_bytes=80 * 10**9).n_layers == 32


def test_serve_main_refuses_before_drawing(monkeypatch):
    """With a card of 80 GB, `main` raises for the full-depth deepseek
    before any weight is drawn (a draw would need a CUDA build here)."""
    class Props:
        total_memory = 80 * 10**9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    with pytest.raises(ValueError, match="--max-repeats"):
        tserve.main(["--arch", DEEPSEEK])


def test_model_flops_counts_active_params_and_mla_widths():
    g = treg.get_config(GRANITE)
    pairs = 4096 * 4097 // 2
    assert ttrain.model_flops(g, 8, 4096) == \
        6.0 * g.active_param_count() * 8 * 4096 + 6.0 * 8 * 32 * 24 * 128 * pairs
    assert g.param_count() / g.active_param_count() > 3.7
    d = treg.cut_depth(treg.get_config(DEEPSEEK), 4)
    n = d.active_param_count() - d.vocab_padded * d.d_model     # the untied input table
    assert ttrain.model_flops(d, 2, 1024) == \
        6.0 * n * 2 * 1024 + 6.0 * 2 * 5 * 128 * (192 + 128) * (1024 * 1025 // 2)
