"""The port's training path against the JAX package's: the synthetic data,
AdamW, `forward_train` with its gradients, and `make_train_step`, on the
same numpy weights (the reference's `init_tree`, f32 master copy) and the
same `SyntheticLM` batches.

Models: reduced qwen2-1.5b (2 layers), falcon-mamba-7b and
recurrentgemma-9b (2 repeats of each layer group), batch 4 x 64 tokens with
a loss chunk of 24, which shrinks to 16 (4 checkpointed chunks), and a
vocab of 500, padded to 512, so that the loss masks the padding.

Tolerances (rtol = atol):
- 1e-4 in f32, the port's model tolerance: the same math summed in another
  order (XLA's reductions and scans against PyTorch's), over a few layers
  and, for the train step, three AdamW steps;
- 5e-2 in bf16 compute, the repo's bf16 model tolerance: each framework
  rounds its bf16 products and casts at its own points;
- the data pipeline is compared bit for bit, and AdamW's leaves at 1e-4
  (f32) and 5e-2 (bf16: a leaf cast back to bf16 may round to the
  neighbouring value).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_tree as j_init  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
ARCHS = ["qwen2-1.5b", "falcon-mamba-7b", "recurrentgemma-9b"]
B, S, LOSS_CHUNK, VOCAB = 4, 64, 24, 500


def _cfgs(arch, **kw):
    """The reduced arch (qwen2-1.5b: 2 layers; the others: 2 repeats of
    each layer group) in both packages."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.smoke_config(arch)
        out.append(dataclasses.replace(
            cfg, blocks=tuple((p, 2) for p, _ in cfg.blocks), loss_chunk=LOSS_CHUNK,
            vocab=VOCAB, **kw))
    return out


def _batch(cfg, step=0, seed=5):
    return jdata.SyntheticLM(cfg, jdata.DataConfig(seed=seed, global_batch=B, seq_len=S)).batch(step)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, _ = _cfgs(request.param)
    tree = jax.tree_util.tree_map(np.asarray, j_init(JT.build_descriptors(jc),
                                                     jax.random.PRNGKey(0)))
    return request.param, tree


def _close(got, exp, tol=F32):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def _close_trees(got, exp, tol=F32):
    g, e = tree_leaves(got), jax.tree_util.tree_leaves(exp)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,num_shards",
                         [(1234, 0, 0, 1), (1234, 7, 1, 2), (17, 3, 3, 4), (0, 100, 0, 1)])
def test_synthetic_batches_equal_reference(seed, step, shard, num_shards):
    jc, tc = _cfgs("qwen2-1.5b")
    exp = jdata.SyntheticLM(jc, jdata.DataConfig(seed=seed, global_batch=8, seq_len=33))
    got = tdata.SyntheticLM(tc, tdata.DataConfig(seed=seed, global_batch=8, seq_len=33))
    e, g = exp.batch(step, shard, num_shards), got.batch(step, shard, num_shards)
    assert sorted(g) == sorted(e) == ["labels", "tokens"]
    for k in e:
        assert g[k].dtype == np.int32
        np.testing.assert_array_equal(g[k], e[k])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _random_tree(rng):
    """f32 and bf16 leaves in nested dicts and a list (bf16 drawn in f32
    numpy and cast inside each framework)."""
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32),
                  {"c": rng.standard_normal((2, 2, 2)).astype(np.float32)}],
            "z": rng.standard_normal((4,)).astype(np.float32)}


BF16_KEYS = ("z",)       # leaves stored in bf16 by both frameworks


def _to_j(tree):
    return {k: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if k in BF16_KEYS else jnp.float32), v)
        for k, v in tree.items()}


def _to_t(tree):
    return {k: tree_map(lambda a: torch.from_numpy(a.copy()).to(
        torch.bfloat16 if k in BF16_KEYS else torch.float32), v) for k, v in tree.items()}


def test_adamw_schedule_matches_reference():
    hp = dict(lr=3e-4, warmup=5, total_steps=20, min_lr_frac=0.1)
    for step in range(25):
        _close(tadamw.schedule(tadamw.Hyper(**hp), step),
               jadamw.schedule(jadamw.Hyper(**hp), jnp.asarray(step, jnp.int32)))


@pytest.mark.parametrize("max_norm", [1e9, 0.5])
def test_adamw_norm_clip_and_update_match_reference(max_norm):
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    hp = dict(lr=1e-2, warmup=2, total_steps=5)
    jp, tp = _to_j(params), _to_t(params)
    jst, tst = jadamw.init(jp), tadamw.init(tp)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tst))
    for step in range(4):
        grads = _random_tree(rng)
        jg, tg = _to_j(grads), _to_t(grads)
        _close(tadamw.global_norm(tg), jadamw.global_norm(jg))
        jg, jn = jadamw.clip_by_global_norm(jg, max_norm)
        tg, tn = tadamw.clip_by_global_norm(tg, max_norm)
        _close(tn, jn)
        assert [t.dtype for t in tree_leaves(tg)] == [t.dtype for t in tree_leaves(tp)]
        for k in params:
            _close_trees(tg[k], jg[k], BF16 if k in BF16_KEYS else F32)
        jp, jst = jadamw.update(jg, jst, jp, jnp.asarray(step, jnp.int32), jadamw.Hyper(**hp))
        tp, tst = tadamw.update(tg, tst, tp, step, tadamw.Hyper(**hp))
        for k in params:
            tol = BF16 if k in BF16_KEYS else F32
            _close_trees(tp[k], jp[k], tol)
            _close_trees(tst["m"][k], jst["m"][k], tol)
            _close_trees(tst["v"][k], jst["v"][k], tol)
    assert tp["z"].dtype == torch.bfloat16


def test_adamw_converges_on_quadratic():
    """tests/test_substrate.py::test_adamw_converges_on_quadratic, on the port."""
    hp = tadamw.Hyper(lr=0.1, warmup=0, weight_decay=0.0, clip=1e9,
                      total_steps=200, min_lr_frac=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = tadamw.init(params)
    target = torch.tensor([1.0, 2.0])
    for step in range(200):
        grads = {"w": params["w"] - target}
        params, opt = tadamw.update(grads, opt, params, step, hp)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# forward_train: loss and gradients
# ---------------------------------------------------------------------------

def _ref_value_and_grad(jc, tree, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.forward_train(jc, p, b), has_aux=True))
    return fn(tree, _j(batch))


def _port_value_and_grad(tc, tree, batch):
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    loss, metrics = TT.forward_train(tc, params, _t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss, metrics, grads


def test_forward_train_loss_and_grads_match_reference(model):
    arch, tree = model
    jc, tc = _cfgs(arch)
    batch = _batch(jc)
    (j_loss, j_m), j_grads = _ref_value_and_grad(jc, tree, batch)
    t_loss, t_m, t_grads = _port_value_and_grad(tc, tree, batch)
    _close(t_loss, j_loss)
    _close(t_m["ce"], j_m["ce"])
    assert float(t_m["aux"]) == 0.0
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(t_grads) == len(j_leaves)
    for g, e in zip(t_grads, j_leaves):
        assert tuple(g.shape) == e.shape
        _close(g, e)


def test_bf16_compute_loss_and_grads_match_reference():
    """bf16 compute on the f32 master copy, with the group params cast once
    (`bf16_param_stack`) and the cotangents pinned to bf16."""
    kw = dict(compute_dtype="bfloat16", bf16_param_stack=True, cotangent_dtype="bfloat16")
    jc, tc = _cfgs("qwen2-1.5b", **kw)
    tree = jax.tree_util.tree_map(np.asarray, j_init(JT.build_descriptors(jc),
                                                     jax.random.PRNGKey(0)))
    batch = _batch(jc)
    (j_loss, _), j_grads = _ref_value_and_grad(jc, tree, batch)
    t_loss, _, t_grads = _port_value_and_grad(tc, tree, batch)
    _close(t_loss, j_loss, BF16)
    for g, e in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        assert g.dtype == torch.float32                  # the master copy's dtype
        _close(g, e, BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_use_pallas_in_train_mode_raises(arch):
    """The kernels are forward-only; training never falls back to the plain
    path behind the caller's back."""
    _, tc = _cfgs(arch, use_pallas=True)
    params = ttrain.init_params(tc, 0, "cpu")
    with pytest.raises(NotImplementedError, match="forward-only"):
        TT.forward_train(tc, params, _t(_batch(tc)))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

REMATS = ["none", "nothing_saveable", "dots_with_no_batch_dims"]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("remat", REMATS)
def test_train_step_matches_reference(microbatches, remat):
    """Three steps of reduced qwen2-1.5b: loss, grad_norm and lr per step,
    then the params and AdamW moments."""
    jc, tc = _cfgs("qwen2-1.5b", remat=remat)
    tree = jax.tree_util.tree_map(np.asarray, j_init(JT.build_descriptors(jc),
                                                     jax.random.PRNGKey(1)))
    kw = dict(lr=3e-4, warmup=2, total_steps=3, microbatches=microbatches)
    j_step = jax.jit(jsteps.make_train_step(jc, jadamw.Hyper(**kw)))
    t_step = tsteps.make_train_step(tc, tadamw.Hyper(**kw))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    jo, to = jadamw.init(jp), tadamw.init(tp)
    for step in range(3):
        batch = _batch(jc, step)
        jp, jo, jm = j_step(jp, jo, _j(batch), jnp.asarray(step, jnp.int32))
        tp, to, tm = t_step(tp, to, _t(batch), step)
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in jm:
            _close(tm[k], jm[k])
    _close_trees(tp, jp)
    _close_trees(to, jo)


# ---------------------------------------------------------------------------
# the trainer's entry point
# ---------------------------------------------------------------------------

ARGS = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "3", "--seq-len", "32",
        "--batch", "4", "--microbatches", "2"]


def test_train_main_runs_on_the_cpu(capsys):
    res = ttrain.main(ARGS + ["--device", "cpu"])
    losses = [r["loss"] for r in res["steps"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(np.isfinite(r["grad_norm"]) and r["step_ms"] > 0 for r in res["steps"])
    assert res["mfu"] is None and res["peak_mem_bytes"] is None   # no device numbers off the card
    assert '"summary": "train"' in capsys.readouterr().out


def test_train_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(ARGS)


def test_model_flops_counts_params_and_causal_pairs():
    cfg = treg.get_config("qwen2-1.5b")
    n = cfg.param_count()
    pairs = 4096 * 4097 // 2
    assert ttrain.model_flops(cfg, 8, 4096) == \
        6.0 * n * 8 * 4096 + 12.0 * 8 * 28 * 12 * 128 * pairs
