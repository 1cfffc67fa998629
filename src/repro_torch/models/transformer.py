"""Model assembly: layer groups, prefill and decode entry points.

The layer stack is a sequence of (pattern, repeats) groups (see
`ModelConfig.blocks`).  Each group's parameters are stacked along a leading
`reps` dim, as in the JAX package; where that package `lax.scan`s a group,
the port runs a Python loop over `reps` and slices the stacked parameters.

The `attn`, `mamba` and `rglru` mixers with the `dense` FFN or none are
ported; the other layer kinds raise and name their ROADMAP.md item.
Training (`forward_train`, `chunked_ce_loss`) comes in a later slice.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (ParamDesc, init_tree, stack_desc,
                                       tree_map, tree_map_desc)

_NOT_PORTED = {
    "mla": "MoE and MLA (ROADMAP.md, Queue 1)",
    "moe": "MoE and MLA (ROADMAP.md, Queue 1)",
    "cross_attn": "the remaining archs (ROADMAP.md, Queue 1)",
    "enc_dec": "the remaining archs (ROADMAP.md, Queue 1)",
    "sinusoidal": "the remaining archs (ROADMAP.md, Queue 1)",
}


def _check_ported(cfg: ModelConfig, spec: LayerSpec):
    kinds = [spec.mixer if spec.mixer not in ("attn", "mamba", "rglru") else None,
             spec.ffn if spec.ffn not in ("dense", "none") else None,
             "cross_attn" if spec.cross_attn else None,
             "enc_dec" if cfg.enc_dec else None,
             cfg.pos_embed if cfg.pos_embed != "rope" else None]
    for kind in kinds:
        if kind is not None:
            where = _NOT_PORTED.get(kind, "ROADMAP.md")
            raise NotImplementedError(f"{kind!r} layers are not ported yet: {where}")


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def layer_descs(cfg: ModelConfig, spec: LayerSpec):
    _check_ported(cfg, spec)
    if spec.mixer == "mamba":
        d: dict[str, Any] = {"mixer": SSM.mamba_descs(cfg)}
    elif spec.mixer == "rglru":
        d = {"mixer": R.rglru_descs(cfg)}
    else:
        d = {"mixer": A.attn_descs(cfg)}
    if spec.ffn == "dense":
        d["ffn"] = L.ffn_descs(cfg)
    return d


def build_descriptors(cfg: ModelConfig):
    descs: dict[str, Any] = dict(L.embed_descs(cfg))
    descs["final_norm"] = L.norm_descs(cfg)
    descs["blocks"] = [
        stack_desc({f"l{i}": layer_descs(cfg, s) for i, s in enumerate(pattern)},
                   reps)
        for pattern, reps in cfg.blocks
    ]
    return descs


def layer_cache_descs(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int):
    if spec.mixer == "mamba":
        return {"mixer": SSM.mamba_cache_descs(cfg, batch)}
    if spec.mixer == "rglru":
        return {"mixer": R.rglru_cache_descs(cfg, batch)}
    return {"mixer": A.attn_cache_descs(cfg, batch, seq, spec.window)}


def build_cache_descriptors(cfg: ModelConfig, batch: int, seq: int):
    return [
        stack_desc({f"l{i}": layer_cache_descs(cfg, s, batch, seq)
                    for i, s in enumerate(pattern)}, reps)
        for pattern, reps in cfg.blocks
    ]


# ---------------------------------------------------------------------------
# single layer and layer groups
# ---------------------------------------------------------------------------

def apply_layer(cfg: ModelConfig, spec: LayerSpec, p, x, *, mode, cache, pos_t):
    """-> (x, new_cache)."""
    _check_ported(cfg, spec)
    c_mix = cache.get("mixer") if cache else None
    if spec.mixer == "mamba":
        x, nc = SSM.apply_mamba(cfg, p["mixer"], x, mode=mode, cache=c_mix, pos_t=pos_t)
    elif spec.mixer == "rglru":
        x, nc = R.apply_rglru(cfg, p["mixer"], x, mode=mode, cache=c_mix, pos_t=pos_t)
    else:
        x, nc = A.apply_attn(cfg, p["mixer"], x, window=spec.window,
                             causal=spec.causal, mode=mode, cache=c_mix, pos_t=pos_t)
    if spec.ffn == "dense":
        x = L.apply_ffn(cfg, p["ffn"], x)
    return x, {"mixer": nc}


def _index(tree, r: int):
    return tree_map(lambda t: t[r], tree)


def run_blocks(cfg: ModelConfig, blocks_params, x, *, mode, caches=None,
               pos_t=None):
    """Run all (pattern, repeats) groups.  Returns (x, new_caches).

    Prefill returns each group's caches stacked along a leading `reps` dim,
    as the JAX package's scan does.  Decode writes into `caches` in place
    (each layer's cache is a view of its group's stacked tensor; attention
    writes its new k and v, the recurrent mixers their new state and conv
    tail) and returns them.
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r}: training is ported in a "
                                  f"later slice (ROADMAP.md, Queue 1)")
    new_caches = []
    for gi, (pattern, reps) in enumerate(cfg.blocks):
        per_rep = []
        for r in range(reps):
            p_r = _index(blocks_params[gi], r)
            c_r = _index(caches[gi], r) if mode == "decode" else None
            ncs = {}
            for i, spec in enumerate(pattern):
                x, ncs[f"l{i}"] = apply_layer(
                    cfg, spec, p_r[f"l{i}"], x, mode=mode,
                    cache=c_r[f"l{i}"] if c_r else None, pos_t=pos_t)
            per_rep.append(ncs)
        if mode == "decode":
            new_caches.append(caches[gi])
        else:
            new_caches.append(tree_map(lambda *ts: torch.stack(ts), *per_rep))
    return x, new_caches


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens):
    return L.apply_embed(cfg, params, tokens)


def _logits(cfg: ModelConfig, params, x):
    """f32 logits from the (tied) table, sliced to the true vocab.

    Both operands go to f32: a bf16 product is exact in f32, so this is the
    JAX package's bf16 dot with an f32 result.
    """
    table = L.unembed_table(cfg, params).to(x.dtype)
    logits = torch.matmul(x.float(), table.float().t())
    return logits[:, :, :cfg.vocab]


def prefill(cfg: ModelConfig, params, tokens):
    """-> (last_token_logits, caches)."""
    x = embed_tokens(cfg, params, tokens)
    x, caches = run_blocks(cfg, params["blocks"], x, mode="prefill")
    x = L.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos_t):
    """tokens: (B, 1); pos_t: int -> (logits, caches), caches updated in place."""
    x = embed_tokens(cfg, params, tokens)
    x, new_caches = run_blocks(cfg, params["blocks"], x, mode="decode",
                               caches=caches, pos_t=pos_t)
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
    def prefill(self, tokens):
        return prefill(self.cfg, self.params, tokens)

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos_t):
        return decode_step(self.cfg, self.params, caches, tokens, pos_t)
