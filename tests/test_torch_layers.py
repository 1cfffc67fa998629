"""The port's configs, parameter tree and layer primitives against the JAX
package's, on the same numpy weights and inputs (f32).

Tolerance 1e-5: the same math, summed in another order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import count_params as j_count, init_tree as j_init  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (count_params as t_count, init_tree as t_init,  # noqa: E402
                                       params_from_numpy, tree_leaves)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-1.5b"


def _cfgs(**kw):
    return (dataclasses.replace(jreg.smoke_config(ARCH), **kw),
            dataclasses.replace(treg.smoke_config(ARCH), **kw))


def _weights(jdescs, seed=0):
    """The reference's init_tree output as numpy, and the port's tensors."""
    tree = jax.tree_util.tree_map(np.asarray, j_init(jdescs, jax.random.PRNGKey(seed)))
    return tree, params_from_numpy(tree, "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, exp, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **(tol or TOL))


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(smoke):
    """Every ported arch, at full width and reduced."""
    get_j = jreg.smoke_config if smoke else jreg.get_config
    get_t = treg.smoke_config if smoke else treg.get_config
    assert treg.ARCH_NAMES == ["qwen2-1.5b", "falcon-mamba-7b", "recurrentgemma-9b",
                               "granite-moe-3b-a800m", "deepseek-v2-236b", "qwen1.5-0.5b",
                               "stablelm-12b", "gemma3-27b", "qwen2-vl-7b", "whisper-large-v3"]
    assert sorted(treg.ARCH_NAMES) == sorted(jreg.ARCH_NAMES)
    for arch in treg.ARCH_NAMES:
        jc, tc = get_j(arch), get_t(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch
        assert (jc.head_dim, jc.vocab_padded, jc.n_layers) == \
            (tc.head_dim, tc.vocab_padded, tc.n_layers)
        assert jc.param_count() == tc.param_count(), arch


def test_unported_arch_raises_and_names_roadmap():
    """Every arch of the reference is ported; a name neither package knows
    raises KeyError, as the reference's registry does."""
    for reg in (jreg, treg):
        with pytest.raises(KeyError, match="unknown arch"):
            reg.get_config("whisper-tiny")


def test_param_tree_layout_matches_reference():
    jc, tc = _cfgs(blocks=((jreg.get_config(ARCH).blocks[0][0], 2),))
    jdescs, tdescs = JT.build_descriptors(jc), TT.build_descriptors(tc)
    assert j_count(jdescs) == t_count(tdescs)
    tree, params = _weights(jdescs)
    assert params["blocks"][0]["l0"]["mixer"]["wq"].shape == (2, 64, 4, 16)
    jshapes = [a.shape for a in jax.tree_util.tree_leaves(tree)]
    assert jshapes == [tuple(t.shape) for t in tree_leaves(params)]
    fresh = t_init(tdescs, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == jshapes


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm(norm):
    jc, tc = _cfgs(norm=norm)
    tree, params = _weights(JL.norm_descs(jc))
    tree = jax.tree_util.tree_map(lambda a: a + _x(a.shape, 2), tree)  # non-trivial scale/bias
    params = params_from_numpy(tree, "cpu")
    x = _x((2, 5, jc.d_model)) * 3.0
    _close(TL.apply_norm(tc, params, torch.from_numpy(x)), JL.apply_norm(jc, tree, x))


@pytest.mark.parametrize("gated", [True, False])
def test_ffn(gated):
    jc, tc = _cfgs(gated_ffn=gated)
    tree, params = _weights(JL.ffn_descs(jc))
    x = _x((2, 7, jc.d_model))
    _close(TL.apply_ffn(tc, params, torch.from_numpy(x)), JL.apply_ffn(jc, tree, x))


@pytest.mark.parametrize("rot_dim", [None, 8])
def test_rope(rot_dim):
    jc, tc = _cfgs()
    x = _x((2, 9, 4, 16))
    pos = np.arange(9)[None] + 3
    exp = JL.apply_rope(jc, x, jnp.asarray(pos), rot_dim=rot_dim)
    got = TL.apply_rope(tc, torch.from_numpy(x), torch.from_numpy(pos), rot_dim=rot_dim)
    _close(got, exp)
    _close(TL.positions_for(tc, torch.from_numpy(x), torch.from_numpy(pos)),
           JL.positions_for(jc, x, jnp.asarray(pos)))


@pytest.mark.parametrize("tie,scale", [(True, False), (False, True)])
def test_embed_and_unembed(tie, scale):
    jc, tc = _cfgs(tie_embeddings=tie, embed_scale=scale)
    tree, params = _weights(JL.embed_descs(jc))
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, 6)).astype(np.int32)
    _close(TL.apply_embed(tc, params, torch.from_numpy(toks)),
           JL.apply_embed(jc, tree, jnp.asarray(toks)))
    _close(TL.unembed_table(tc, params), JL.unembed_table(jc, tree))


def test_mrope_is_not_ported():
    """M-RoPE is ported: qwen2-vl-7b's sections (16, 24, 24) at head_dim
    128, through `positions_for`, with distinct (B, 3, S) position ids and
    with text ids (B, S)."""
    jc = jreg.get_config("qwen2-vl-7b")
    tc = treg.get_config("qwen2-vl-7b")
    x = _x((2, 9, 2, 128))
    rng = np.random.default_rng(5)
    for pos in (rng.integers(0, 4096, (2, 3, 9)), np.arange(9)[None].repeat(2, 0) + 100):
        _close(TL.positions_for(tc, torch.from_numpy(x), torch.from_numpy(pos)),
               JL.positions_for(jc, x, jnp.asarray(pos)), rtol=2e-5, atol=2e-5)
