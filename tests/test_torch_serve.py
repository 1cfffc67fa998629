"""The port's serving path against the JAX package's: reduced qwen2-1.5b
(2 layers), the same numpy weights and prompts, f32.

Tolerance 1e-4: the reference's blocked online softmax (or its Pallas
kernel in interpret mode) against the port's plain softmax, over 2 layers.
Also: the port's own decode-vs-prefill consistency, its entry points
without a card, and the import guard (the port imports neither `jax` nor
the JAX package).
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_tree as j_init  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import is_desc, params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "qwen2-1.5b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, N_DECODE = 2, 64, 4
REPO = Path(__file__).resolve().parents[1]


def _cfgs(use_pallas, window=0):
    """Reduced qwen2-1.5b with 2 layers in one group (DENSE, window)."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.smoke_config(ARCH)
        spec = dataclasses.replace(cfg.blocks[0][0][0], window=window)
        out.append(dataclasses.replace(cfg, blocks=(((spec,), 2),), use_pallas=use_pallas))
    return out


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs(False)
    tree = jax.tree_util.tree_map(
        np.asarray, j_init(JT.build_descriptors(jc), jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    return tree, params_from_numpy(tree, "cpu"), toks


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


CASES = [(False, 0), (True, 0), (False, 16), (True, 16)]


@pytest.mark.parametrize("use_pallas,window", CASES)
def test_prefill_and_decode_match_reference(weights, use_pallas, window):
    tree, params, toks = weights
    jc, tc = _cfgs(use_pallas, window)
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


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_tokens_equal_reference(weights, use_pallas):
    tree, params, toks = weights
    jc, tc = _cfgs(use_pallas)
    j_logits, j_caches = jsteps.make_prefill_step(jc)(tree, {"tokens": jnp.asarray(toks[:, :S])})
    t_logits, t_caches = tsteps.make_prefill_step(tc)(params, {"tokens": torch.from_numpy(toks[:, :S])})
    j_caches = _grow_ref(j_caches, S, S + N_DECODE)
    t_caches = tserve.grow_caches(t_caches, S, S + N_DECODE)
    j_tok = jnp.argmax(j_logits[:, -1], -1).astype(jnp.int32)[:, None]
    t_tok = torch.argmax(t_logits[:, -1], -1).to(torch.int32)[:, None]
    j_step, t_step = jsteps.make_serve_step(jc), tsteps.make_serve_step(tc)
    j_out, t_out = [j_tok], [t_tok]
    for i in range(N_DECODE - 1):
        j_tok, j_caches = j_step(tree, j_caches, j_tok, jnp.asarray(S + i, jnp.int32))
        t_tok, t_caches = t_step(params, t_caches, t_tok, S + i)
        j_out.append(j_tok)
        t_out.append(t_tok)
    np.testing.assert_array_equal(torch.cat(t_out, 1).numpy(), np.concatenate(j_out, 1))
    # serve() drives the same steps
    res = tserve.serve(tc, batch=B, prompt_len=S, new_tokens=N_DECODE, device="cpu",
                       params=params, prompts=torch.from_numpy(toks[:, :S]))
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(j_out, 1))


@pytest.mark.parametrize("use_pallas,window", CASES)
def test_port_decode_matches_its_prefill(weights, use_pallas, window):
    """Prefill P tokens and decode token P == prefill P + 1 tokens (f32)."""
    _, params, toks = weights
    _, tc = _cfgs(use_pallas, window)
    model = TT.Transformer(tc, params)
    _, caches = model.prefill(torch.from_numpy(toks[:, :S]))
    caches = tserve.grow_caches(caches, S, S + 1)
    logits_d, _ = model.decode_step(caches, torch.from_numpy(toks[:, S:S + 1]), S)
    logits_f, _ = model.prefill(torch.from_numpy(toks[:, :S + 1]))
    _close(logits_d, logits_f.numpy())


@pytest.mark.parametrize("window", [0, 16])
def test_init_cache_matches_reference(window):
    jc, tc = _cfgs(False, window)
    exp = JT.init_cache(jc, B, S)
    got = TT.init_cache(tc, B, S, "cpu")
    assert [str(t.dtype).split(".")[-1] for t in tree_leaves(got)] == \
        [str(a.dtype) for a in jax.tree_util.tree_leaves(exp)]
    _close_trees(got, exp)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot be shown")
    _, tc = _cfgs(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(tc, batch=1, prompt_len=4, new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--batch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.Transformer(tc, generator=torch.Generator())
    res = tserve.serve(tc, batch=1, prompt_len=4, new_tokens=2, device="cpu")
    assert res["tokens"].shape == (1, 2)


def test_transformer_stores_drawn_weights_in_the_compute_dtype():
    """Every weight in bf16 but the norm scales, which the reference reads
    in f32 and which so stay f32."""
    _, tc = _cfgs(False)
    tc = dataclasses.replace(tc, compute_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    model = TT.Transformer(tc, generator=gen, device="cpu")
    descs = tree_leaves(TT.build_descriptors(tc), is_leaf=is_desc)
    got = [t.dtype for t in tree_leaves(model.params)]
    assert got == [torch.float32 if d.f32 else torch.bfloat16 for d in descs]
    assert sum(d.f32 for d in descs) == 3   # the group's attention and FFN norms, the final norm
    logits, _ = model.prefill(torch.from_numpy(np.zeros((B, 8), np.int64)))
    assert logits.shape == (B, 1, tc.vocab) and bool(torch.isfinite(logits).all())


def test_unported_layer_kinds_raise():
    """Every layer kind is ported: MLA and MoE, and the cross-attention,
    encoder-decoder and sinusoidal configs build the reference's descriptor
    tree (the same paths and shapes)."""
    jc, tc = _cfgs(False)
    for arch in ("granite-moe-3b-a800m", "deepseek-v2-236b"):
        assert TT.build_descriptors(treg.smoke_config(arch))
    cross = (((LayerSpec(cross_attn=True),), 1),)
    for kw in (dict(blocks=cross), dict(enc_dec=True, blocks=cross),
               dict(pos_embed="sinusoidal")):
        jt = JT.build_descriptors(dataclasses.replace(jc, **kw))
        tt = TT.build_descriptors(dataclasses.replace(tc, **kw))
        j_paths = [(jax.tree_util.keystr(path), d.shape)
                   for path, d in jax.tree_util.tree_leaves_with_path(
                       jt, is_leaf=lambda x: hasattr(x, "axes"))]
        t_leaves = tree_leaves(tt, is_leaf=is_desc)
        assert [shape for _, shape in j_paths] == [d.shape for d in t_leaves]
        keys = "".join(p for p, _ in j_paths)
        assert ("cross" in keys) == ("blocks" in kw) and ("encoder" in keys) == ("enc_dec" in kw)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the scheduling stack, the tooling and the benchmarks are in the walk
    assert {"core", "launch", "distributed", "benchmarks"} <= {f.parent.name for f in files}
    bad = [(f.relative_to(REPO), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
