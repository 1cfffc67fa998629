"""The last five archs against the JAX package: qwen1.5-0.5b, stablelm-12b,
gemma3-27b, qwen2-vl-7b and whisper-large-v3, and the pieces they brought
(M-RoPE, sinusoidal positions, bidirectional and cross-attention, the
encoder, `logits_dtype`, the ring-cache repair), on the same numpy weights
and inputs, f32.

Tolerances are the reference's: 2e-5 for a layer, 1e-4 for a model (the
same math, summed in another order over a few layers).  With `use_pallas`
the port's kernel wrapper takes its plain version on the CPU and the
reference runs its Pallas kernel in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_tree as j_init  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map  # noqa: E402

LAYER = dict(rtol=2e-5, atol=2e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen1.5-0.5b", "stablelm-12b", "gemma3-27b", "qwen2-vl-7b", "whisper-large-v3"]
B, S, N_DECODE = 2, 24, 3
WHISPER = "whisper-large-v3"


def _cfgs(arch, **kw):
    return [dataclasses.replace(reg.smoke_config(arch), **kw) for reg in (jreg, treg)]


def _numpy_tree(descs, seed=0):
    return jax.tree_util.tree_map(np.asarray, j_init(descs, jax.random.PRNGKey(seed)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, exp, tol=MODEL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def _close_trees(got, exp, tol=MODEL):
    g, e = tree_leaves(got), jax.tree_util.tree_leaves(exp)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def _grow_ref(caches, cur, total):
    """The reference's cache growth (examples/serve_lm.py::_grow), held to
    the self-attention caches as the port's `grow_caches` is."""
    def grow(path, x):
        if (path[-2].key == "mixer" and path[-1].key in tserve.ATTN_CACHE_KEYS
                and x.shape[2] == cur):
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, total - cur)
            return jnp.pad(x, pad, constant_values=-1 if x.dtype == jnp.int32 else 0)
        return x
    return jax.tree_util.tree_map_with_path(grow, caches)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ids", ["distinct", "text"])
def test_apply_mrope_matches_reference(ids):
    """Distinct (B, 3, S) ids turn each section by its own position; with
    text ids (B, S) all three sections take the same one."""
    jc, tc = _cfgs("qwen2-vl-7b")
    x = _x((B, 9, 4, tc.head_dim))
    rng = np.random.default_rng(2)
    pos = (rng.integers(0, 50, (B, 3, 9)) if ids == "distinct"
           else np.arange(9)[None].repeat(B, 0) + 3)
    exp = JL.apply_mrope(jc, x, jnp.asarray(pos))
    _close(TL.apply_mrope(tc, torch.from_numpy(x), torch.from_numpy(pos)), exp, LAYER)
    _close(TL.positions_for(tc, torch.from_numpy(x), torch.from_numpy(pos)), exp, LAYER)
    if ids == "distinct":   # and the sections do differ from plain RoPE there
        rope = TL.apply_rope(tc, torch.from_numpy(x), torch.from_numpy(pos[:, 0]))
        assert not np.allclose(rope.numpy(), np.asarray(exp), atol=1e-3)


@pytest.mark.parametrize("d_model,first,last", [(64, 0, 64), (1280, 384, 448),
                                                (64, 0, 1500), (1280, 0, 1500)])
def test_sinusoidal_pos_matches_reference(d_model, first, last):
    """Held at 2e-5 plus last x 2^-23: the two packages' f32 `exp` of a
    frequency may differ by one ulp (2^-24 relative, seen at some
    frequencies), and the angle position x frequency carries that to
    position x 2^-24 radians; at whisper's 1500 frames that is 9e-5."""
    pos = np.arange(first, last)
    tol = 2e-5 + last * 2.0 ** -23
    _close(TL.sinusoidal_pos(d_model, torch.from_numpy(pos)),
           JL.sinusoidal_pos(d_model, jnp.asarray(pos)), dict(rtol=0, atol=tol))


# ---------------------------------------------------------------------------
# bidirectional and cross-attention, the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_q,T", [(40, 40), (24, 8), (64, 128)])
def test_bidir_attention_matches_reference(S_q, T):
    """kv_block 32: T <= 64 takes the dense branch, T = 128 the online one."""
    q, k, v = _x((B, S_q, 4, 16), 3), _x((B, T, 4, 16), 4), _x((B, T, 4, 16), 5)
    exp = JA.bidir_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=0.25, kv_block=32)
    got = TA.bidir_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.25, kv_block=32)
    _close(got, exp, LAYER)


def test_cross_attention_layer_in_prefill_and_decode():
    """Prefill: k and v from the encoder's output, cached; decode: only q
    is projected, against that cache, which stays as it was."""
    jc, tc = _cfgs(WHISPER)
    tree = _numpy_tree(JA.attn_descs(jc, cross=True), seed=3)
    p = params_from_numpy(tree, "cpu")
    x, x1, enc = _x((B, 7, jc.d_model), 1), _x((B, 1, jc.d_model), 2), _x((B, 8, jc.d_model), 3)
    kw = dict(window=0, causal=False, cross=True)
    j_out, j_cache = JA.apply_attn(jc, tree, jnp.asarray(x), mode="prefill",
                                   enc_out=jnp.asarray(enc), **kw)
    t_out, t_cache = TA.apply_attn(tc, p, torch.from_numpy(x), mode="prefill",
                                   enc_out=torch.from_numpy(enc), **kw)
    _close(t_out, j_out, LAYER)
    _close_trees(t_cache, j_cache, LAYER)
    j_out, _ = JA.apply_attn(jc, tree, jnp.asarray(x1), mode="decode", cache=j_cache,
                             pos_t=7, **kw)
    before = {k: t.clone() for k, t in t_cache.items()}
    t_out, t_cache2 = TA.apply_attn(tc, p, torch.from_numpy(x1), mode="decode",
                                    cache=t_cache, pos_t=7, **kw)
    _close(t_out, j_out, LAYER)
    assert t_cache2 is t_cache and all(torch.equal(before[k], t_cache[k]) for k in before)


@pytest.fixture(scope="module")
def whisper():
    jc, _ = _cfgs(WHISPER)
    tree = _numpy_tree(JT.build_descriptors(jc))
    enc = _x((B, jc.enc_frames, jc.d_model), 7)
    return tree, params_from_numpy(tree, "cpu"), enc


@pytest.mark.parametrize("use_pallas", [False, True])
def test_run_encoder_matches_reference(whisper, use_pallas):
    """With `use_pallas` the port runs the encoder's bidirectional layers
    through the flash wrapper without autograd, and refuses while autograd
    records (the kernel is forward-only)."""
    tree, params, enc = whisper
    jc, tc = _cfgs(WHISPER, use_pallas=use_pallas)
    exp = JT.run_encoder(jc, tree, jnp.asarray(enc))
    with torch.no_grad():
        got = TT.run_encoder(tc, params, torch.from_numpy(enc))
    _close(got, exp)
    if use_pallas:
        with pytest.raises(NotImplementedError, match="forward-only"):
            TT.run_encoder(tc, params, torch.from_numpy(enc))


def test_whisper_forward_train_loss_and_every_grad_match_reference(whisper):
    tree, _, _ = whisper
    jc, tc = _cfgs(WHISPER, loss_chunk=12)
    batch = jdata.SyntheticLM(jc, jdata.DataConfig(seed=5, global_batch=B, seq_len=S)).batch(0)
    assert batch["enc_feats"].shape == (B, jc.enc_frames, jc.d_model)
    fn = jax.value_and_grad(lambda p, b: JT.forward_train(jc, p, b), has_aux=True)
    (j_loss, _), j_grads = fn(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    t_loss, _ = TT.forward_train(tc, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(t_loss, tree_leaves(params))
    _close(t_loss, j_loss)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(grads) == len(j_leaves) and any(
        "encoder" in str(path) for path, _ in jax.tree_util.tree_leaves_with_path(j_grads))
    for g, e in zip(grads, j_leaves):
        _close(g, e)


def test_chunked_ce_loss_honours_logits_dtype():
    """bf16 logits, the padded vocab masked in bf16, then f32 for the
    log-sum-exp, as the reference does.  Held at 1e-3: both packages round
    the same f32 logits to bf16, but where the two f32 sums (taken in
    another order) straddle a rounding boundary the bf16 values differ by one
    ulp, up to 2^-8 of the logit; over a mean of 96 tokens that moves the
    loss by about 1e-4, and f32 logits land within 1e-5 of it."""
    kw = dict(vocab=500, loss_chunk=32)
    jc, tc = _cfgs("qwen2-1.5b", **kw)
    assert jc.vocab_padded > jc.vocab                      # the mask is exercised
    tree = _numpy_tree(JL.embed_descs(jc))
    x = _x((3, 32, jc.d_model)) * 4.0
    labels = np.random.default_rng(4).integers(0, jc.vocab, (3, 32))
    out = {}
    for ldt in ("float32", "bfloat16"):
        j, t = (dataclasses.replace(c, logits_dtype=ldt) for c in (jc, tc))
        exp = JT.chunked_ce_loss(j, tree, jnp.asarray(x), jnp.asarray(labels))
        got = TT.chunked_ce_loss(t, params_from_numpy(tree, "cpu"), torch.from_numpy(x),
                                 torch.from_numpy(labels))
        _close(got, exp, dict(rtol=1e-3, atol=1e-3) if ldt == "bfloat16" else LAYER)
        out[ldt] = float(got)
    assert out["bfloat16"] != out["float32"]               # the rounding is really taken


# ---------------------------------------------------------------------------
# the five reduced archs, served
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, _ = _cfgs(request.param)
    tree = _numpy_tree(JT.build_descriptors(jc))
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    enc = _x((B, jc.enc_frames, jc.d_model), 9) if jc.enc_dec else None
    return request.param, tree, params_from_numpy(tree, "cpu"), toks, enc


def _enc(enc, framework):
    if enc is None:
        return None
    return jnp.asarray(enc) if framework == "jax" else torch.from_numpy(enc)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(model, use_pallas):
    """Prefill logits and caches, then N_DECODE decode steps' logits and the
    caches after them (whisper's cross caches included)."""
    arch, tree, params, toks, enc = model
    jc, tc = _cfgs(arch, use_pallas=use_pallas)
    j_logits, j_caches = JT.prefill(jc, tree, jnp.asarray(toks[:, :S]), _enc(enc, "jax"))
    t_logits, t_caches = TT.prefill(tc, params, torch.from_numpy(toks[:, :S]),
                                    _enc(enc, "torch"))
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
    """The reference's prefill and serve steps against the port's `serve()`
    end to end, with the kernels on."""
    arch, tree, params, toks, enc = model
    jc, tc = _cfgs(arch, use_pallas=True)
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    if enc is not None:
        batch["enc_feats"] = jnp.asarray(enc)
    j_logits, j_caches = jsteps.make_prefill_step(jc)(tree, batch)
    j_caches = _grow_ref(j_caches, S, S + N_DECODE)
    j_tok = jnp.argmax(j_logits[:, -1], -1).astype(jnp.int32)[:, None]
    j_step, j_out = jsteps.make_serve_step(jc), [j_tok]
    for i in range(N_DECODE - 1):
        j_tok, j_caches = j_step(tree, j_caches, j_tok, jnp.asarray(S + i, jnp.int32))
        j_out.append(j_tok)
    res = tserve.serve(tc, batch=B, prompt_len=S, new_tokens=N_DECODE, device="cpu",
                       params=params, prompts=torch.from_numpy(toks[:, :S]),
                       enc_feats=_enc(enc, "torch"))
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(j_out, 1))


# ---------------------------------------------------------------------------
# the ring cache: prompts longer than the window
# ---------------------------------------------------------------------------

def _gemma3_window_8():
    out = []
    for c in _cfgs("gemma3-27b"):
        blocks = tuple((tuple(dataclasses.replace(s, window=8 if s.window else 0) for s in p), r)
                       for p, r in c.blocks)
        out.append(dataclasses.replace(c, blocks=blocks))
    return out


@pytest.fixture(scope="module")
def gemma3_w8():
    jc, tc = _gemma3_window_8()
    tree = _numpy_tree(JT.build_descriptors(jc), seed=2)
    toks = np.random.default_rng(3).integers(0, jc.vocab, (B, 17)).astype(np.int32)
    return jc, tc, tree, params_from_numpy(tree, "cpu"), toks


@pytest.mark.parametrize("P", [12, 13, 16])
def test_ring_cache_decode_matches_the_longer_prefill(gemma3_w8, P):
    """Reduced gemma3-27b with its windows cut to 8.  The port's decode of
    token P after a P-token prefill equals the reference's (P+1)-token
    prefill, also at P 12 and 13, which 8 does not divide and where the
    reference's own decode is off by about 0.1 (its prefill keeps the last 8
    keys in slots 0..7, and its first decode step overwrites one still in
    the window).  At P 16, a multiple of 8, the port's ring equals the
    reference's, and so does the decode."""
    jc, tc, tree, params, toks = gemma3_w8
    _, t_caches = TT.prefill(tc, params, torch.from_numpy(toks[:, :P]))
    t_caches = tserve.grow_caches(t_caches, P, P + 1)
    t_logits, _ = TT.decode_step(tc, params, t_caches, torch.from_numpy(toks[:, P:P + 1]), P)
    j_full, _ = JT.prefill(jc, tree, jnp.asarray(toks[:, :P + 1]))
    _close(t_logits, j_full)
    j_logits, j_caches = JT.prefill(jc, tree, jnp.asarray(toks[:, :P]))
    j_caches = _grow_ref(j_caches, P, P + 1)
    j_dec, _ = JT.decode_step(jc, tree, j_caches, jnp.asarray(toks[:, P:P + 1]),
                              jnp.asarray(P, jnp.int32))
    if P % 8 == 0:
        _close(t_logits, j_dec)
    else:
        assert np.abs(np.asarray(j_dec) - np.asarray(j_full)).max() > 1e-2


def test_ring_prefill_puts_position_p_in_slot_p_mod_w(gemma3_w8):
    jc, tc, tree, params, toks = gemma3_w8
    _, caches = TT.prefill(tc, params, torch.from_numpy(toks[:, :13]))
    ring = caches[0]["l0"]["mixer"]                        # a local layer
    assert ring["pos"].shape[-1] == 8
    np.testing.assert_array_equal(ring["pos"][0, 0].numpy(), [8, 9, 10, 11, 12, 5, 6, 7])
    _, j_caches = JT.prefill(jc, tree, jnp.asarray(toks[:, :13]))
    j_ring = j_caches[0]["l0"]["mixer"]
    np.testing.assert_array_equal(np.asarray(j_ring["pos"][0, 0]), np.arange(5, 13))
    _close(ring["k"], np.roll(np.asarray(j_ring["k"]), 13 % 8, axis=2))


# ---------------------------------------------------------------------------
# cache growth with an encoder-decoder
# ---------------------------------------------------------------------------

def test_grow_caches_leaves_the_cross_cache_alone(whisper):
    """A prompt as long as the encoder's frames (8): only the self-attention
    caches grow; decode then matches the port's own longer prefill."""
    tree, params, enc = whisper
    _, tc = _cfgs(WHISPER)
    P = tc.enc_frames
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, tc.vocab, (B, P + 1)))
    _, caches = TT.prefill(tc, params, toks[:, :P], torch.from_numpy(enc))
    layer = caches[0]["l0"]
    assert layer["mixer"]["k"].shape[2] == layer["cross"]["k"].shape[2] == P
    grown = tserve.grow_caches(caches, P, P + 4)
    assert grown[0]["l0"]["mixer"]["k"].shape[2] == P + 4
    assert grown[0]["l0"]["cross"]["k"] is layer["cross"]["k"]
    logits_d, _ = TT.decode_step(tc, params, grown, toks[:, P:], P)
    logits_f, _ = TT.prefill(tc, params, toks, torch.from_numpy(enc))
    _close(logits_d, logits_f.numpy())
