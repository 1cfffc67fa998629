"""Shared model primitives: norms, FFN, embeddings, rotary, M-RoPE and
sinusoidal positions, and the cotangent dtype barrier of training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import add_partial, constrain, embed_rows
from repro_torch.models.params import ParamDesc


# what a mixer with `use_pallas` says in train mode
FORWARD_ONLY = ("{kernel}: the kernel is forward-only (the reference defines no "
                "VJP for its Pallas kernel), so training runs the plain path; "
                "set use_pallas=False to train")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


class _CotangentCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype), None


def cotangent_cast(x, dtype: torch.dtype):
    """Identity whose cotangent is cast to `dtype`: a dtype barrier that
    stops the f32 CE-loss cotangent from propagating f32 activation grads
    through the whole stack.  (Autograd casts a gradient back to its
    input's dtype, so on an f32 `x` this rounds the cotangent to `dtype`.)"""
    return _CotangentCast.apply(x, dtype)


# ---------------------------------------------------------------------------
# activations / norms
# ---------------------------------------------------------------------------

def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def norm_descs(cfg: ModelConfig, d: int | None = None):
    d = d or cfg.d_model
    out = {"scale": ParamDesc((d,), ("embed",), init="ones", f32=True)}
    if cfg.norm == "layernorm":
        out["bias"] = ParamDesc((d,), ("embed",), init="zeros", f32=True)
    return out


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6, axes=None):
    """The block's norm of x; under the dry run's rules laid out by `axes`,
    by default ("batch", None, ...): see below."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    # the projections read the norm's output whole along the sequence: under
    # the dry run's rules a sequence-sharded residual is gathered here (the
    # JAX package leaves that gather to XLA); elsewhere a no-op
    return constrain(y.to(x.dtype), axes or ("batch",) + (None,) * (x.ndim - 1))


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm: normalize the last (head_dim) axis."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


STREAM = ("batch", "seq_act", None)     # the residual stream (B, S, d)


def residual(x, out):
    """x + out, a block's output added to the residual stream.  Under the dry
    run's rules `out` is laid out as the stream is first, explicitly: the
    partial sum a sharded output projection leaves is reduced here, once a
    block, whatever a torch version's rule for adding a partial sum to a
    replicated stream would choose, and in the backward the gradient comes
    back gathered along the sequence (a sequence-sharded gradient cannot be
    flattened into the products' rows without a strided shard); elsewhere a
    plain add."""
    return x + constrain(out, STREAM)


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def ffn_descs(cfg: ModelConfig, d_ff: int | None = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    descs = {
        "norm": norm_descs(cfg),
        "w1": ParamDesc((d, ff), ("embed", "ff")),
        "w2": ParamDesc((ff, d), ("ff", "embed")),
    }
    if cfg.gated_ffn:
        descs["w3"] = ParamDesc((d, ff), ("embed", "ff"))
    else:
        descs["b1"] = ParamDesc((ff,), ("ff",), init="zeros")
        descs["b2"] = ParamDesc((d,), ("embed",), init="zeros")
    return descs


def apply_ffn(cfg: ModelConfig, p, x):
    cdt = compute_dtype(cfg)
    h = apply_norm(cfg, p["norm"], x)
    act = act_fn(cfg.act)
    if cfg.gated_ffn:
        g = torch.matmul(h, p["w1"].to(cdt))
        u = torch.matmul(h, p["w3"].to(cdt))
        out = torch.matmul(act(g) * u, p["w2"].to(cdt))
    else:
        z = act(torch.matmul(h, p["w1"].to(cdt)) + p["b1"].to(cdt))
        out = add_partial(torch.matmul(z, p["w2"].to(cdt)), p["b2"].to(cdt))
    return residual(x, out)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_descs(cfg: ModelConfig):
    descs = {"embed": {"table": ParamDesc((cfg.vocab_padded, cfg.d_model),
                                          ("vocab", "embed"), scale=0.02)}}
    if not cfg.tie_embeddings:
        descs["unembed"] = {"table": ParamDesc((cfg.vocab_padded, cfg.d_model),
                                               ("vocab", "embed"), scale=0.02)}
    return descs


def apply_embed(cfg: ModelConfig, params, tokens):
    cdt = compute_dtype(cfg)
    # under the dry run's rules the lookup's partial sums over the
    # vocab-sharded table are reduced at once, in the compute dtype, before
    # anything else reads them
    x = constrain(embed_rows(params["embed"]["table"], tokens, cdt), STREAM)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    return x


def unembed_table(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["unembed"]["table"]


# ---------------------------------------------------------------------------
# positions: RoPE (half-split form), M-RoPE, sinusoidal
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, rot_dim: int, device=None):
    half = rot_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (cfg.rope_theta ** exps)  # (half,)


def apply_rope(cfg: ModelConfig, x, positions, rot_dim: int | None = None):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    D = x.shape[-1]
    rot = rot_dim or D
    half = rot // 2
    inv = rope_freqs(cfg, rot, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot < D:
        out = torch.cat([out, x[..., rot:].to(out.dtype)], dim=-1)
    return out.to(x.dtype)


def apply_mrope(cfg: ModelConfig, x, positions):
    """Qwen2-VL M-RoPE: the head_dim/2 frequency slots are cut into
    `cfg.mrope_sections` (temporal, height, width); slot i turns by the
    position id of its section.  x: (..., S, H, D); positions: (..., S),
    the same id for all three sections (a text stream), or (..., 3, S)."""
    D = x.shape[-1]
    half = D // 2
    sections = cfg.mrope_sections
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim/2 = {half}")
    if positions.dim() == x.dim() - 2:
        positions = torch.stack([positions] * 3, dim=-2)
    inv = rope_freqs(cfg, D, device=x.device)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                        for i, n in enumerate(sections)])        # (half,)
    pos_slot = positions.movedim(-2, -1)[..., sec_id]            # (..., S, half)
    ang = pos_slot.float() * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_pos(d_model: int, positions):
    """Whisper's sinusoids: positions (...,) -> (..., d_model), f32."""
    half = d_model // 2
    inv = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                    * (math.log(10000.0) / max(1, half - 1)))
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def positions_for(cfg: ModelConfig, q, pos):
    """Apply the configured positional scheme to q/k tensors (..., S, H, D)."""
    if cfg.mrope_sections:
        return apply_mrope(cfg, q, pos)
    return apply_rope(cfg, q, pos)
