"""The port's recurrent slice against the JAX package: the Mamba and RG-LRU
blocks, and reduced falcon-mamba-7b and recurrentgemma-9b (2 repeats per
layer group) served end to end, on the same numpy weights and prompts, f32,
with `use_pallas` off (the plain chunked scans) and on (the kernel wrappers,
which take their plain versions on the CPU; the reference runs its Pallas
kernels in interpret mode).

Tolerance 1e-4: the same math, summed and scanned in another order over a
few layers.  The prompt is as long as the recurrent state is wide (d_inner
for Mamba, lru_width for the RG-LRU), so that growing the caches for decode
must tell an attention cache from a recurrent state by name, not by width.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jreg  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_tree as j_init  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (init_tree as t_init, is_desc,  # noqa: E402
                                       params_from_numpy, tree_leaves)

TOL = dict(rtol=1e-4, atol=1e-4)
B, N_DECODE = 2, 4
ARCHS = ["falcon-mamba-7b", "recurrentgemma-9b"]
PALLAS = [False, True]


def _cfgs(arch, use_pallas=False):
    """The reduced arch with 2 repeats of each layer group."""
    return [dataclasses.replace(reg.smoke_config(arch), use_pallas=use_pallas,
                                blocks=tuple((p, 2) for p, _ in reg.smoke_config(arch).blocks))
            for reg in (jreg, treg)]


def _prompt_len(cfg):
    """As long as the recurrent state is wide (64 for the reduced RG-LRU,
    128 for the reduced Mamba's d_inner)."""
    return cfg.rglru.lru_width if cfg.rglru else cfg.ssm.expand * cfg.d_model


def _weights(jdescs, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, j_init(jdescs, jax.random.PRNGKey(seed)))
    return tree, params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, tc = _cfgs(request.param)
    tree, params = _weights(JT.build_descriptors(jc))
    S = _prompt_len(tc)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    return request.param, tree, params, toks, S


def _close(got, exp):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(exp, np.float32), **TOL)


def _close_trees(got, exp):
    g, e = tree_leaves(got), jax.tree_util.tree_leaves(exp)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert tuple(a.shape) == b.shape
        _close(a, b)


def _grow_ref(caches, cur, total):
    """The reference's cache growth (examples/serve_lm.py::_grow), held to
    the attention caches (`k`, `v`, `pos`) as the port's `grow_caches` is."""
    def grow(path, x):
        if path[-1].key in tserve.ATTN_CACHE_KEYS and x.shape[2] == cur:
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, total - cur)
            return jnp.pad(x, pad, constant_values=-1 if x.dtype == jnp.int32 else 0)
        return x
    return jax.tree_util.tree_map_with_path(grow, caches)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mamba", "rglru"])
@pytest.mark.parametrize("use_pallas", PALLAS)
def test_block_matches_reference_in_prefill_and_decode(kind, use_pallas):
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-9b"
    jc, tc = _cfgs(arch, use_pallas)
    j_apply, t_apply = ((JS.apply_mamba, TS.apply_mamba) if kind == "mamba"
                        else (JR.apply_rglru, TR.apply_rglru))
    jdescs = JS.mamba_descs(jc) if kind == "mamba" else JR.rglru_descs(jc)
    tree, params = _weights(jdescs, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 37, jc.d_model), dtype=np.float32)
    x1 = rng.standard_normal((B, 1, jc.d_model), dtype=np.float32)

    j_out, j_cache = j_apply(jc, tree, jnp.asarray(x), mode="prefill")
    t_out, t_cache = t_apply(tc, params, torch.from_numpy(x), mode="prefill")
    _close(t_out, j_out)
    _close_trees(t_cache, j_cache)

    j_out, j_cache = j_apply(jc, tree, jnp.asarray(x1), mode="decode", cache=j_cache, pos_t=37)
    t_out, t_cache2 = t_apply(tc, params, torch.from_numpy(x1), mode="decode",
                              cache=t_cache, pos_t=37)
    assert t_cache2 is t_cache                    # written in place
    _close(t_out, j_out)
    _close_trees(t_cache, j_cache)


# ---------------------------------------------------------------------------
# the reduced models, served
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", PALLAS)
def test_prefill_and_decode_match_reference(model, use_pallas):
    arch, tree, params, toks, S = model
    jc, tc = _cfgs(arch, use_pallas)
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


@pytest.mark.parametrize("use_pallas", PALLAS)
def test_greedy_tokens_equal_reference(model, use_pallas):
    arch, tree, params, toks, S = model
    jc, tc = _cfgs(arch, use_pallas)
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


@pytest.mark.parametrize("use_pallas", PALLAS)
def test_port_decode_matches_its_prefill(model, use_pallas):
    """Prefill P tokens and decode token P == prefill P + 1 tokens (f32)."""
    arch, _, params, toks, S = model
    _, tc = _cfgs(arch, use_pallas)
    m = TT.Transformer(tc, params)
    _, caches = m.prefill(torch.from_numpy(toks[:, :S]))
    caches = tserve.grow_caches(caches, S, S + 1)
    logits_d, _ = m.decode_step(caches, torch.from_numpy(toks[:, S:S + 1]), S)
    logits_f, _ = m.prefill(torch.from_numpy(toks[:, :S + 1]))
    _close(logits_d, logits_f.numpy())


def test_grow_caches_pads_attention_caches_only(model):
    """The recurrent state is as wide as the prompt is long; only `k`, `v`
    and `pos` grow, and ring slots grow with the invalid marker -1."""
    arch, _, params, toks, S = model
    _, tc = _cfgs(arch)
    _, caches = TT.prefill(tc, params, torch.from_numpy(toks[:, :S]))
    grown = tserve.grow_caches(caches, S, S + 3)
    for g, (pattern, _) in enumerate(tc.blocks):
        for i, spec in enumerate(pattern):
            before, after = caches[g][f"l{i}"]["mixer"], grown[g][f"l{i}"]["mixer"]
            if spec.mixer == "attn":
                assert after["k"].shape[2] == after["pos"].shape[2] == S + 3
                assert bool((after["pos"][:, :, S:] == -1).all())
            else:
                assert before["state"].shape[2] == S     # what a width test mistakes for a sequence
                for key in ("state", "conv"):
                    assert after[key] is before[key]


def test_init_cache_matches_reference(model):
    arch, *_ = model
    jc, tc = _cfgs(arch)
    exp = JT.init_cache(jc, B, 16)
    got = TT.init_cache(tc, B, 16, "cpu")
    assert [str(t.dtype).split(".")[-1] for t in tree_leaves(got)] == \
        [str(a.dtype) for a in jax.tree_util.tree_leaves(exp)]
    _close_trees(got, exp)


def test_param_tree_layout_matches_reference(model):
    arch, tree, params, *_ = model
    _, tc = _cfgs(arch)
    jshapes = [a.shape for a in jax.tree_util.tree_leaves(tree)]
    assert jshapes == [tuple(t.shape) for t in tree_leaves(params)]
    fresh = t_init(TT.build_descriptors(tc), torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == jshapes


def test_drawn_weights_keep_f32_leaves_and_draw_lru_a():
    """In bf16, the leaves the reference reads in f32 (A_log, a_param, norm
    scales) stay f32, and a_param is drawn as the reference draws it:
    sigmoid(a_param) ** 8 in (0.9, 0.999)."""
    for arch in ARCHS:
        _, tc = _cfgs(arch)
        tc = dataclasses.replace(tc, compute_dtype="bfloat16")
        gen = torch.Generator().manual_seed(0)
        params = t_init(TT.build_descriptors(tc), gen, "cpu", dtype=torch.bfloat16)
        descs = tree_leaves(TT.build_descriptors(tc), is_leaf=is_desc)
        assert [t.dtype for t in tree_leaves(params)] == \
            [torch.float32 if d.f32 else torch.bfloat16 for d in descs]
        mixer = params["blocks"][0]["l0"]["mixer"]
        if arch == "falcon-mamba-7b":
            assert mixer["A_log"].dtype == torch.float32
        else:
            a = torch.sigmoid(mixer["a_param"]) ** 8
            assert mixer["a_param"].dtype == torch.float32
            assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
            assert float(a.std()) > 0.01                  # drawn, not constant
