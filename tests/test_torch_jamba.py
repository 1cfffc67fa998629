"""ai21-jamba2-mini's mechanisms in the port, on the CPU at small sizes:
the registry keeps the JAX package's names, the Mamba inner norms off
leave plain Mamba-1 as it was bit for bit, the dropless expert layer
computes every assignment to its held experts at any skew, the gates are
the plain top-2 probabilities, and no positional signal enters without
RoPE.  The model against its plain reference: the benchmark's
`portbench/tests/test_portbench_jamba.py`.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import init_tree  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

JAX_NAMES = ["qwen2-1.5b", "falcon-mamba-7b", "recurrentgemma-9b", "granite-moe-3b-a800m",
             "deepseek-v2-236b", "qwen1.5-0.5b", "stablelm-12b", "gemma3-27b", "qwen2-vl-7b",
             "whisper-large-v3"]


def _small():
    """Reduced ai21-jamba2-mini: two blocks of 8 layers, 8 experts, 4 held."""
    cfg = treg.reduced(treg.get_config("ai21-jamba2-mini"))
    return dataclasses.replace(cfg, blocks=tuple((p, 2) for p, _ in cfg.blocks),
                               moe=dataclasses.replace(cfg.moe, n_held=4, first_held=2))


def _params(cfg, seed=0):
    return init_tree(TT.build_descriptors(cfg), torch.Generator().manual_seed(seed), "cpu")


def test_the_registry_resolves_the_name_and_keeps_the_jax_packages_list():
    assert treg.ARCH_NAMES == JAX_NAMES
    cfg = treg.get_config("ai21-jamba2-mini")
    served = tserve.served_config("ai21-jamba2-mini")
    assert served.use_pallas and served.blocks == cfg.blocks
    specs = cfg.layer_specs()
    assert len(specs) == 16 and cfg.pos_embed == "none" and not cfg.tie_embeddings
    assert [i for i, s in enumerate(specs) if s.mixer == "attn"] == [4, 12]
    assert [i for i, s in enumerate(specs) if s.ffn == "moe"] == list(range(1, 16, 2))
    m = cfg.moe
    assert (m.n_experts, m.held, m.first_held, m.top_k, m.expert_ff) == (16, 8, 0, 2, 14336)
    assert m.dispatch == "dropless" and not m.renormalize and cfg.ssm.inner_norms
    assert cfg.param_count() == pytest.approx(14.78e9, rel=2e-3)


def _plain_gates(cfg, p, xc):
    """`ssm._gates` as it stood without the inner norms (plain Mamba-1)."""
    dtr, N = SSM.dt_rank(cfg), cfg.ssm.d_state
    proj = torch.einsum("bsd,de->bse", xc, p["x_proj"])
    dt_r, Bm, Cm = proj[..., :dtr], proj[..., dtr:dtr + N], proj[..., dtr + N:]
    return F.softplus(torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"]) + p["dt_bias"]), Bm, Cm


def test_inner_norms_off_leave_plain_mamba_bit_for_bit():
    """falcon-mamba-7b (the option off): the scan's and the state step's
    inputs are plain Mamba-1's, bit for bit, Bm and Cm still views of the
    projection; prefill and decode logits equal to the plain gates'."""
    cfg = treg.smoke_config("falcon-mamba-7b")
    assert not cfg.ssm.inner_norms and "dt_norm" not in SSM.mamba_descs(cfg)
    params = _params(cfg)
    p = params["blocks"][0]["l0"]["mixer"]
    p = {k: v[0] for k, v in p.items() if k != "norm"}
    xc = torch.randn(2, 7, cfg.ssm.expand * cfg.d_model)
    got, want = SSM._gates(cfg, p, xc), _plain_gates(cfg, p, xc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1]._base is not None and got[2]._base is got[1]._base
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    runs = []
    for gates in (SSM._gates, lambda c, p, x: _plain_gates(c, p, x)):
        old, SSM._gates = SSM._gates, gates
        try:
            logits, caches = TT.prefill(cfg, params, toks[:, :11])
            caches = tserve.grow_caches(caches, 11, 12)
            step, _ = TT.decode_step(cfg, params, caches, toks[:, 11:].to(torch.int32), 11)
        finally:
            SSM._gates = old
        runs.append((logits, step, caches[0]["l0"]["mixer"]["state"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_inner_norms_on_norm_dt_b_and_c_with_their_scales():
    cfg = _small()
    p = {k: v[0] for k, v in _params(cfg)["blocks"][0]["l0"]["mixer"].items() if k != "norm"}
    g = torch.Generator().manual_seed(3)
    for name in ("dt_norm", "b_norm", "c_norm"):
        p[name] = torch.rand(p[name].shape, generator=g) + 0.5
    xc = torch.randn(2, 5, cfg.ssm.expand * cfg.d_model, generator=g)
    dt, Bm, Cm = SSM._gates(cfg, p, xc)
    dtr, N = SSM.dt_rank(cfg), cfg.ssm.d_state
    proj = xc @ p["x_proj"]

    def rms(t, s):
        return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + 1e-6) * s

    want_dt = F.softplus(rms(proj[..., :dtr], p["dt_norm"]) @ p["dt_proj"] + p["dt_bias"])
    assert torch.allclose(dt, want_dt, atol=1e-6)
    assert torch.allclose(Bm, rms(proj[..., dtr:dtr + N], p["b_norm"]), atol=1e-6)
    assert torch.allclose(Cm, rms(proj[..., dtr + N:], p["c_norm"]), atol=1e-6)


def _moe_params(cfg, seed=0):
    descs = M.moe_descs(cfg)
    return init_tree(descs, torch.Generator().manual_seed(seed), "cpu")


def _dense_moe(cfg, p, x):
    """The held experts' part of the layer's output, expert by expert over
    every token (f32), and the router's top-k."""
    m = cfg.moe
    h = L.apply_norm(cfg, p["norm"], x)
    probs = torch.softmax(h @ p["router"], -1)
    w, i = torch.topk(probs, m.top_k, -1)
    if m.renormalize:
        w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m.held):
        ye = (F.silu(h @ p["w1"][e]) * (h @ p["w3"][e])) @ p["w2"][e]
        y = y + (w * (i == m.first_held + e)).sum(-1)[..., None] * ye
    return y, i


def test_a_skewed_router_drops_nothing_and_the_counters_say_so():
    """Every token routed to held expert 1 first and expert 3 second: the
    layer computes all 2 x 48 assignments (a capacity layer would keep
    `capacity(12, 2, 8, 1.25)` = 4 slots of each sequence, 16 of each
    expert's 48), and its counters, kept while the profiler records, read
    0 dropped."""
    cfg = _small()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, first_held=0))
    p = _moe_params(cfg)
    with torch.no_grad():
        p["router"].zero_()
        p["router"][:, 1] = 1.0
        p["router"][:, 3] = 0.5
    x = torch.rand(4, 12, cfg.d_model, generator=torch.Generator().manual_seed(1)) + 0.1
    M.reset_counters()
    with torch.no_grad():
        y, _ = M.apply_moe(cfg, p, x)
        assert M.counters() == []                     # nothing counted untraced
        with profile(activities=[ProfilerActivity.CPU]):
            y2, _ = M.apply_moe(cfg, p, x)
    want, idx = _dense_moe(cfg, p, x)
    assert (idx[..., 0] == 1).all() and (idx[..., 1] == 3).all()
    assert torch.allclose(y - x, want, atol=1e-5) and torch.equal(y, y2)
    (layer,) = M.counters()
    assert layer["assigned"] == 96 and layer["held"] == 96 and layer["dropped"] == 0
    assert layer["per_expert"] == [0, 48, 0, 48] and layer["calls"] == [[0, 48, 0, 48]]
    M.reset_counters()
    assert M.counters() == []


def test_unheld_experts_add_nothing_and_held_ones_everything():
    cfg = _small()                                     # experts 2-5 of 8 held
    p = _moe_params(cfg, 2)
    x = torch.randn(3, 9, cfg.d_model, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        y, _ = M.apply_moe(cfg, p, x)
    want, idx = _dense_moe(cfg, p, x)
    held = (idx >= 2) & (idx < 6)
    assert held.any() and (~held).any()
    assert torch.allclose(y - x, want, atol=1e-5)


def test_the_gates_are_the_top_k_probabilities_not_renormalised():
    cfg = _small()
    p = _moe_params(cfg, 3)
    h = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(5))
    probs, w, i = M.route(cfg, p, h)
    top = torch.topk(torch.softmax(h @ p["router"], -1), 2, -1)
    assert torch.allclose(w, top.values) and torch.equal(i, top.indices)
    assert (w.sum(-1) < 1).all()
    renorm = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, renormalize=True))
    _, w2, _ = M.route(renorm, p, h)
    assert torch.allclose(w2, w / w.sum(-1, keepdim=True))


def test_the_capacity_dispatch_refuses_a_share_of_the_experts():
    cfg = _small()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="scatter"))
    with pytest.raises(ValueError, match="dropless"):
        M.apply_moe(cfg, _moe_params(cfg), torch.randn(1, 4, cfg.d_model))


def test_no_positional_signal_without_rope():
    """pos_embed "none": the embedding adds nothing at any offset; a query's
    output does not change when the keys before it are permuted, in
    prefill, nor in a decode step over the cache of the permuted prompt
    (with RoPE both change)."""
    cfg = _small()
    attn_cfg = dataclasses.replace(cfg, blocks=(((cfg.blocks[0][0][4],), 1),))
    params = _params(attn_cfg)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(6))
    assert torch.equal(TT.embed_tokens(cfg, params, toks, 7), TT.embed_tokens(cfg, params, toks))
    p = {k: (v[0] if not isinstance(v, dict) else {"scale": v["scale"][0]})
         for k, v in params["blocks"][0]["l0"]["mixer"].items()}
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(7))
    perm = torch.cat([torch.randperm(8, generator=torch.Generator().manual_seed(8)),
                      torch.tensor([8])])
    q = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(9))
    for pos_embed, same in (("none", True), ("rope", False)):
        c = dataclasses.replace(cfg, pos_embed=pos_embed)
        outs, steps = [], []
        for rows in (x, x[:, perm]):
            with torch.no_grad():
                out, cache = A.apply_attn(c, p, rows, window=0, mode="prefill")
                (grown,) = tserve.grow_caches([{"l0": {"mixer": {k: v[None] for k, v in
                                                                 cache.items()}}}], 9, 10)
                cache = {k: v[0] for k, v in grown["l0"]["mixer"].items()}
                step, _ = A.apply_attn(c, p, q, window=0, mode="decode", cache=cache, pos_t=9)
            outs.append(out[:, -1])
            steps.append(step)
        assert torch.allclose(*outs, atol=1e-5) == same, pos_embed
        assert torch.allclose(*steps, atol=1e-5) == same, pos_embed


def test_the_served_steps_carry_kv_mamba_state_and_conv_tail_together():
    """Reduced ai21-jamba2-mini through make_prefill_step and make_serve_step
    over caches grown by serve.grow_caches: each decode step's logits equal
    a prefill's of the longer prompt (f32)."""
    cfg = dataclasses.replace(_small(), use_pallas=False)
    params = _params(cfg, 1)
    P, n = 10, 4
    toks = torch.randint(0, cfg.vocab, (2, P + n), generator=torch.Generator().manual_seed(2))
    _, caches = tsteps.make_prefill_step(cfg)(params, {"tokens": toks[:, :P]})
    caches = tserve.grow_caches(caches, P, P + n)
    kinds = {k for lay in caches[0].values() for k in lay["mixer"]}
    assert kinds == {"k", "v", "state", "conv"}
    assert caches[0]["l4"]["mixer"]["k"].shape[2] == P + n
    for i in range(n):
        with torch.no_grad():
            logits, caches = TT.decode_step(cfg, params, caches, toks[:, P + i:P + i + 1].int(),
                                            P + i)
            want, _ = TT.prefill(cfg, params, toks[:, :P + i + 1])
        assert torch.allclose(logits, want, atol=2e-5, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the served step's kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_a_decode_step_never_waits_on_the_host(cuda):
    """Reduced ai21-jamba2-mini served through the kernels in bf16: prefill
    reaches flash and the scan, each decode step the state kernel once a
    Mamba layer (14), and a decode step, the dropless experts' sort,
    offsets and grouped products included, makes no synchronising call
    (`torch.cuda.set_sync_debug_mode("error")` raises on one)."""
    from repro_torch.kernels import flash_attention, mamba_scan, mamba_step
    cfg = dataclasses.replace(_small(), use_pallas=True, compute_dtype="bfloat16")
    params = init_tree(TT.build_descriptors(cfg), torch.Generator(device=cuda).manual_seed(0),
                       cuda, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (4, 33), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    launches = (flash_attention.flash_attention.launches, mamba_scan.mamba_scan.launches)
    _, caches = tsteps.make_prefill_step(cfg)(params, {"tokens": toks[:, :32]})
    assert (flash_attention.flash_attention.launches - launches[0],
            mamba_scan.mamba_scan.launches - launches[1]) == (2, 14)
    caches = tserve.grow_caches(caches, 32, 40)
    step = tsteps.make_serve_step(cfg)
    tok, caches = step(params, caches, toks[:, 32:33].to(torch.int32), 32)
    torch.cuda.synchronize()
    before = mamba_step.mamba_state_step.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            tok, caches = step(params, caches, tok, 33 + i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert mamba_step.mamba_state_step.launches - before == 3 * 14
    assert tok.shape == (4, 1) and bool(((tok >= 0) & (tok < cfg.vocab)).all())
