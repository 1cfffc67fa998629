"""Model assembly: layer groups, train, prefill and decode entry points.

The layer stack is a sequence of (pattern, repeats) groups (see
`ModelConfig.blocks`).  Each group's parameters are stacked along a leading
`reps` dim, as in the JAX package; where that package `lax.scan`s a group,
the port runs a Python loop over `reps` and slices the stacked parameters.
In training each repetition's body is checkpointed by `cfg.remat`, as the
reference `jax.checkpoint`s its scanned body, and the loss is a
sequence-chunked cross-entropy whose chunks are checkpointed too, plus the
MoE layers' balance loss.

An encoder-decoder config (whisper) adds an `encoder` tree of
bidirectional attention layers (`ENC_SPEC`), run over the frame embeddings
plus sinusoidal positions in train mode, as the reference runs it even in
prefill; each decoder layer with `cross_attn` attends over the encoder's
output after its self-attention, and its prefill caches that output's keys
and values for decode.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (add_partial, add_whole, constrain, gather_last,
                                              logsumexp_last)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (ParamDesc, init_tree, stack_desc,
                                       tree_map, tree_map_desc)
from repro_torch.models.spans import span

ENC_SPEC = LayerSpec(mixer="attn", window=0, ffn="dense", causal=False)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def layer_descs(cfg: ModelConfig, spec: LayerSpec):
    if spec.mixer == "mamba":
        d: dict[str, Any] = {"mixer": SSM.mamba_descs(cfg)}
    elif spec.mixer == "rglru":
        d = {"mixer": R.rglru_descs(cfg)}
    elif spec.mixer == "mla":
        d = {"mixer": A.mla_descs(cfg)}
    elif spec.mixer == "attn":
        d = {"mixer": A.attn_descs(cfg)}
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.cross_attn:
        d["cross"] = A.attn_descs(cfg)
    if spec.ffn == "dense":
        d["ffn"] = L.ffn_descs(cfg)
    elif spec.ffn == "moe":
        d["moe"] = M.moe_descs(cfg)
    return d


def build_descriptors(cfg: ModelConfig):
    descs: dict[str, Any] = dict(L.embed_descs(cfg))
    descs["final_norm"] = L.norm_descs(cfg)
    descs["blocks"] = [
        stack_desc({f"l{i}": layer_descs(cfg, s) for i, s in enumerate(pattern)},
                   reps)
        for pattern, reps in cfg.blocks
    ]
    if cfg.enc_dec:
        descs["encoder"] = {
            "blocks": [stack_desc({"l0": layer_descs(cfg, ENC_SPEC)}, cfg.n_enc_layers)],
            "final_norm": L.norm_descs(cfg),
        }
    return descs


def layer_cache_descs(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int):
    if spec.mixer == "mamba":
        d = {"mixer": SSM.mamba_cache_descs(cfg, batch)}
    elif spec.mixer == "rglru":
        d = {"mixer": R.rglru_cache_descs(cfg, batch)}
    elif spec.mixer == "mla":
        d = {"mixer": A.mla_cache_descs(cfg, batch, seq)}
    else:
        d = {"mixer": A.attn_cache_descs(cfg, batch, seq, spec.window)}
    if spec.cross_attn:
        # the encoder output's keys and values, enc_frames long
        d["cross"] = A.attn_cache_descs(cfg, batch, cfg.enc_frames, 0)
    return d


def build_cache_descriptors(cfg: ModelConfig, batch: int, seq: int):
    return [
        stack_desc({f"l{i}": layer_cache_descs(cfg, s, batch, seq)
                    for i, s in enumerate(pattern)}, reps)
        for pattern, reps in cfg.blocks
    ]


# ---------------------------------------------------------------------------
# single layer and layer groups
# ---------------------------------------------------------------------------

def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x, *, mode, cache, pos_t,
                enc_out=None):
    """-> (x, new_cache, aux); new_cache is None in train mode; aux is the
    MoE layer's weighted balance loss (an f32 scalar tensor), 0.0 for a
    layer without MoE.  A `cross_attn` layer attends over `enc_out` (train,
    prefill) or its cross cache (decode) after its mixer."""
    c_mix = cache.get("mixer") if cache else None
    aux = 0.0
    with span("repro.mixer"):
        if spec.mixer == "mamba":
            x, nc = SSM.apply_mamba(cfg, p["mixer"], x, mode=mode, cache=c_mix, pos_t=pos_t)
        elif spec.mixer == "rglru":
            x, nc = R.apply_rglru(cfg, p["mixer"], x, mode=mode, cache=c_mix, pos_t=pos_t)
        elif spec.mixer == "mla":
            x, nc = A.apply_mla(cfg, p["mixer"], x, mode=mode, cache=c_mix, pos_t=pos_t)
        else:
            x, nc = A.apply_attn(cfg, p["mixer"], x, window=spec.window,
                                 causal=spec.causal, mode=mode, cache=c_mix, pos_t=pos_t)
    new_cache = {"mixer": nc}
    if spec.cross_attn:
        x, new_cache["cross"] = A.apply_attn(
            cfg, p["cross"], x, window=0, causal=False, mode=mode,
            cache=cache.get("cross") if cache else None, pos_t=pos_t,
            enc_out=enc_out, cross=True)
    if spec.ffn == "dense":
        with span("repro.ffn"):
            x = L.apply_ffn(cfg, p["ffn"], x)
    elif spec.ffn == "moe":
        with span("repro.moe"):
            x, aux = M.apply_moe(cfg, p["moe"], x)
    x = constrain(x, ("batch", "seq_act", None))
    if mode == "train":
        if cfg.cotangent_dtype:
            # pin the residual stream's cotangent dtype at every layer
            # boundary, as the reference does
            x = L.cotangent_cast(x, getattr(torch, cfg.cotangent_dtype))
        return x, None, aux
    return x, new_cache, aux


def _index(tree, r: int):
    return tree_map(lambda t: t[r], tree)


def _unstack(tree, reps: int) -> list:
    """One tree of views per repetition.  Under autograd the gradients of
    the `reps` slices meet once, in one stack into the stacked leaf."""
    sliced = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[r], sliced, is_leaf=lambda t: isinstance(t, tuple))
            for r in range(reps)]


def _save_2d_products(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products with no batch dims: `mm`, and the
    batch-1 `bmm` that `torch.einsum` makes of a projection."""
    if (op is torch.ops.aten.mm.default
            or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1)):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """`fn` checkpointed by `cfg.remat`: "none" saves everything;
    "nothing_saveable" saves only the inputs and recomputes the body in the
    backward; "dots_with_no_batch_dims" also saves the outputs of the 2-D
    matrix products (the projections), as the reference's JAX policy of that
    name does, and recomputes the rest (norms, casts, attention scores).
    No layer draws random numbers, so no RNG state is saved for the
    recompute."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "nothing_saveable":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if cfg.remat == "dots_with_no_batch_dims":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _save_2d_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def run_blocks(cfg: ModelConfig, blocks_params, x, *, mode, caches=None,
               pos_t=None, enc_out=None, block_cfgs=None):
    """Run all (pattern, repeats) groups of `block_cfgs` (`cfg.blocks` by
    default; the encoder passes its own).  Returns (x, new_caches, aux).

    Train mode runs each repetition's body under `_remat`, returns no
    caches (a None per group) and the sum of every layer's aux (an f32
    scalar tensor); the other modes return aux 0.0 (the reference's
    prefill and decode drop theirs).  Prefill returns each group's caches
    stacked along a leading `reps` dim, as the JAX package's scan does.  Decode
    writes into `caches` in place (each layer's cache is a view of its
    group's stacked tensor; attention writes its new k and v, the recurrent
    mixers their new state and conv tail) and returns them.
    """
    block_cfgs = block_cfgs or cfg.blocks
    if mode == "train":
        x, aux = _run_blocks_train(cfg, blocks_params, x, enc_out, block_cfgs)
        return x, [None] * len(block_cfgs), aux
    new_caches = []
    for gi, (pattern, reps) in enumerate(block_cfgs):
        per_rep = []
        for r in range(reps):
            p_r = _index(blocks_params[gi], r)
            c_r = _index(caches[gi], r) if mode == "decode" else None
            ncs = {}
            for i, spec in enumerate(pattern):
                x, ncs[f"l{i}"], _ = apply_layer(
                    cfg, spec, p_r[f"l{i}"], x, mode=mode,
                    cache=c_r[f"l{i}"] if c_r else None, pos_t=pos_t,
                    enc_out=enc_out)
            per_rep.append(ncs)
        if mode == "decode":
            new_caches.append(caches[gi])
        else:
            new_caches.append(tree_map(lambda *ts: torch.stack(ts), *per_rep))
    return x, new_caches, 0.0


def _run_blocks_train(cfg: ModelConfig, blocks_params, x, enc_out, block_cfgs):
    """-> (x, aux summed over every layer)."""
    cdt = L.compute_dtype(cfg)
    auxes = [torch.zeros((), device=x.device)]
    for gi, (pattern, reps) in enumerate(block_cfgs):
        gp = blocks_params[gi]
        if cfg.bf16_param_stack:
            # one cast of the group's floating params per step: the layers
            # read, and their gradients flow through, the compute dtype
            gp = tree_map(lambda t: t.to(cdt) if t.is_floating_point() else t, gp)

        def body(x, p_r, enc_out, _pattern=pattern):
            auxes = [torch.zeros((), device=x.device)]
            for i, spec in enumerate(_pattern):
                x, _, a = apply_layer(cfg, spec, p_r[f"l{i}"], x, mode="train",
                                      cache=None, pos_t=None, enc_out=enc_out)
                auxes.append(a)
            return x, add_partial(*auxes)

        body = _remat(cfg, body)
        for p_r in _unstack(gp, reps):
            x, a = body(x, p_r, enc_out)
            auxes.append(a)
    # under the dry run's rules a MoE layer's balance loss is a partial sum
    # over the batch shards: summed as one, reduced with the loss
    return x, add_partial(*auxes)


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------

def run_encoder(cfg: ModelConfig, params, enc_feats):
    """Frame embeddings (B, F, d) plus sinusoidal positions, through the
    encoder's bidirectional layers in train mode (as the reference runs
    them, in prefill too), then its final norm."""
    cdt = L.compute_dtype(cfg)
    F_ = enc_feats.shape[1]
    x = enc_feats.to(cdt) + L.sinusoidal_pos(
        cfg.d_model, torch.arange(F_, device=enc_feats.device))[None].to(cdt)
    x = constrain(x, ("batch", "seq_act", None))
    x, _, _ = run_blocks(cfg, params["encoder"]["blocks"], x, mode="train",
                         block_cfgs=(((ENC_SPEC,), cfg.n_enc_layers),))
    return L.apply_norm(cfg, params["encoder"]["final_norm"], x)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens, pos_offset=0):
    """Token embeddings; with sinusoidal positions, those of positions
    pos_offset, pos_offset + 1, ... added."""
    x = L.apply_embed(cfg, params, tokens)
    if cfg.pos_embed == "sinusoidal":
        pos = pos_offset + torch.arange(tokens.shape[1], device=tokens.device)
        x = x + L.sinusoidal_pos(cfg.d_model, pos)[None].to(x.dtype)
    return constrain(x, ("batch", "seq_act", None))


def _logits(cfg: ModelConfig, params, x):
    """f32 logits from the (tied) table, sliced to the true vocab.

    Both operands go to f32: a bf16 product is exact in f32, so this is the
    JAX package's bf16 dot with an f32 result.
    """
    with span("repro.logits"):
        with span("repro.logits.table"):
            table = L.unembed_table(cfg, params).to(x.dtype).float()
        logits = torch.matmul(x.float(), table.t())
        return logits[:, :, :cfg.vocab]


def chunked_ce_loss(cfg: ModelConfig, params, x, labels):
    """Mean token cross-entropy over a sequence cut in chunks of
    `cfg.loss_chunk` (shrunk until it divides S).  Each chunk is
    checkpointed, so only one chunk's logits are ever resident: f32 logits
    from the table cast to the compute dtype (both operands then widened to
    f32, which is the reference's bf16 product with an f32 result), rounded
    to `cfg.logits_dtype`, the padded vocab masked to -1e30 in that dtype,
    then widened to f32 for the log-sum-exp, and the label's log-prob by
    gather (the reference's one-hot sum picks the same number).  The sum
    over chunks is divided by B x S (no RNG state is saved: the chunk
    draws no random numbers).  Under the dry run's rules the
    log-sum-exp and the pick run on each rank's own vocab columns, as the
    reference's XLA keeps them: no chunk's logits are gathered."""
    B, S, _ = x.shape
    table = L.unembed_table(cfg, params)
    V, Vp = cfg.vocab, cfg.vocab_padded
    ldt = getattr(torch, cfg.logits_dtype)
    ch = min(cfg.loss_chunk, S)
    while S % ch:
        ch -= 1

    def chunk_fn(x_c, y_c):
        logits = torch.matmul(x_c.float(), table.to(x_c.dtype).float().t()).to(ldt)
        if Vp > V:
            logits = torch.where(torch.arange(Vp, device=x.device) < V, logits,
                                 torch.tensor(A.NEG_INF, dtype=ldt, device=x.device))
        logits = logits.float()
        lse = logsumexp_last(logits)
        ll = gather_last(logits, y_c[..., None].long())[..., 0]
        return (lse - ll).sum()

    # under the dry run's rules each chunk's sum is a partial sum over the
    # rows' shards: the chunks are summed as one, reduced once
    return add_whole(*(ckpt.checkpoint(chunk_fn, x[:, c0:c0 + ch], labels[:, c0:c0 + ch],
                                       use_reentrant=False, preserve_rng_state=False)
                       for c0 in range(0, S, ch))) / (B * S)


def forward_train(cfg: ModelConfig, params, batch):
    """batch: {"tokens", "labels"}, (B, S) integer tensors, and for an
    encoder-decoder "enc_feats" (B, F, d) -> (loss, {"ce", "aux"}): loss =
    ce + aux, with aux the MoE layers' weighted balance loss summed over the
    layers (0 without MoE)."""
    enc_out = run_encoder(cfg, params, batch["enc_feats"]) if cfg.enc_dec else None
    x = embed_tokens(cfg, params, batch["tokens"])
    x, _, aux = run_blocks(cfg, params["blocks"], x, mode="train", enc_out=enc_out)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if cfg.cotangent_dtype:
        x = L.cotangent_cast(x, getattr(torch, cfg.cotangent_dtype))
    ce = chunked_ce_loss(cfg, params, x, batch["labels"])
    return add_whole(ce, aux), {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, tokens, enc_feats=None):
    """-> (last_token_logits, caches).  An encoder-decoder takes its frame
    embeddings `enc_feats` (B, F, d); its encoder runs without autograd (so
    that its train-mode layers may take the forward-only kernel)."""
    enc_out = None
    if cfg.enc_dec:
        with torch.no_grad():
            enc_out = run_encoder(cfg, params, enc_feats)
    with span("repro.embed"):
        x = embed_tokens(cfg, params, tokens)
    with span("repro.blocks"):
        x, caches, _ = run_blocks(cfg, params["blocks"], x, mode="prefill", enc_out=enc_out)
    with span("repro.final_norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos_t):
    """tokens: (B, 1); pos_t: int -> (logits, caches), caches updated in place."""
    with span("repro.embed"):
        x = embed_tokens(cfg, params, tokens, pos_offset=pos_t)
    with span("repro.blocks"):
        x, new_caches, _ = run_blocks(cfg, params["blocks"], x, mode="decode",
                                      caches=caches, pos_t=pos_t)
    with span("repro.final_norm"):
        x = L.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), new_caches


def init_cache(cfg: ModelConfig, batch: int, seq: int, device):
    """Zero-initialized cache (ring-buffer position slots marked invalid)."""
    descs = build_cache_descriptors(cfg, batch, seq)

    def mk(d: ParamDesc):
        if d.dtype == torch.int32:
            return torch.full(d.shape, -1, dtype=torch.int32, device=device)
        return torch.zeros(d.shape, dtype=d.dtype, device=device)

    return [tree_map_desc(mk, g) for g in descs]


class Transformer(nn.Module):
    """Holds a parameter tree (the JAX package's nested layout) and exposes
    `prefill` and `decode_step`.

    With `params=None` the weights are drawn from `generator`, which lives on
    `device`, and stored once in the compute dtype, but for the leaves read
    in f32 (see `init_tree`).
    """

    def __init__(self, cfg: ModelConfig, params=None, *, generator=None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise ValueError("pass either params or a generator")
            params = init_tree(build_descriptors(cfg), generator,
                               resolve_device(device), dtype=L.compute_dtype(cfg))
        self.params = params

    @torch.no_grad()
    def prefill(self, tokens, enc_feats=None):
        return prefill(self.cfg, self.params, tokens, enc_feats)

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos_t):
        return decode_step(self.cfg, self.params, caches, tokens, pos_t)
