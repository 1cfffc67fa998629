"""Attention: blocked causal, banded local-window, bidirectional and decode,
for GQA self- and cross-attention layers, and DeepSeek-V2's multi-head
latent attention (MLA).

Plain PyTorch versions of the JAX package's memory-bounded attention
(`repro/models/attention.py`), with the same blocking so that the two agree
closely:

* causal attention: "super-row" decomposition, online softmax over kv
  blocks inside each row band (q/k and v may differ in width, as MLA's do);
* local (windowed) attention: per q block, a (window + q_block) kv slice;
* bidirectional attention (whisper's encoder and cross-attention): dense,
  or online over kv blocks where the keys are many and the block divides
  them;
* decode: one query against the cache (global), the ring buffer (local),
  or the encoder's keys (cross);
* MLA: low-rank q and kv with RMS-normed latents; prefill expands the
  latent kv per head and runs the causal attention above; decode absorbs
  W_k into the query and attends over the latent cache (`c_kv`, `k_rope`).

With `cfg.use_pallas`, GQA self-attention in prefill (and in the encoder,
which runs in train mode) goes through the hand-written flash kernel
(`repro_torch.kernels.ops.flash_attention`) instead.  Decode stays plain:
the reference has no decode kernel.  Training runs the plain path under
autograd: the kernel is forward-only, as the reference's is (it defines no
VJP), so `use_pallas` in a GQA layer's train mode raises while autograd
records; without it (whisper's encoder inside a prefill) the kernel runs.
Cross-attention and MLA never reach the kernel, in any mode, as in the
reference, so `use_pallas` changes nothing there.

The local layers' ring cache departs from the reference on purpose: prefill
stores position p in slot p mod W, where decode writes and looks for it
(the reference stores the last W positions in slots 0..W-1, which decode
then overwrites while they are still in the window when the prompt is
longer than the window and not a multiple of it).  Where the prompt is no
longer than the window, or a multiple of it, the two caches are equal.

The JAX package's sharding annotations (`constrain`) sit at the same
points; they act only under the dry run's axis rules.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, per_shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDesc

NEG_INF = -1e30
HEADS = ("batch", None, "heads", None)   # q, k, v and o: (B, S, H, D)


# ---------------------------------------------------------------------------
# core attention math (q, k, v already per-head: (B, S, H, D))
# ---------------------------------------------------------------------------

def _online_rows(q_band, k_band, v_band, scale, kv_block, q_start, k_start):
    """Online softmax over kv blocks for one q band.

    q_band: (B, Sr, H, D); k/v_band: (B, P, H, D); causal mask from absolute
    positions (q_start + row, k_start + col).
    """
    B, Sr, H, D = q_band.shape
    nk = k_band.shape[1] // kv_block
    qt = q_band.transpose(1, 2).float()                      # (B,H,Sr,D)
    kt = k_band.transpose(1, 2).float()
    vt = v_band.transpose(1, 2)
    m = torch.full((B, H, Sr), NEG_INF, device=q_band.device)
    den = torch.zeros((B, H, Sr), device=q_band.device)
    acc = torch.zeros((B, H, Sr, v_band.shape[-1]), device=q_band.device)
    rows = q_start + torch.arange(Sr, device=q_band.device)
    for j in range(nk):
        blk = slice(j * kv_block, (j + 1) * kv_block)
        cols = k_start + j * kv_block + torch.arange(kv_block, device=q_band.device)
        s = torch.matmul(qt, kt[:, :, blk].transpose(-1, -2)) * scale
        s = torch.where(cols[None, None, None, :] <= rows[None, None, :, None],
                        s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(vt.dtype).float(), vt[:, :, blk].float())
        m = m_new
    o = acc / torch.clamp(den[..., None], min=1e-30)
    return o.transpose(1, 2).to(q_band.dtype)                 # (B,Sr,H,Dv)


def causal_attention(q, k, v, *, scale, n_super=8, kv_block=512):
    """Exact causal attention, super-row blocked.  q,k,v: (B,S,H,D), S==T."""
    S = q.shape[1]
    n_super = max(1, min(n_super, S // max(1, kv_block)))
    while S % n_super:
        n_super -= 1
    Sr = S // n_super
    kb = math.gcd(Sr, kv_block)
    outs = [_online_rows(q[:, s * Sr:(s + 1) * Sr], k[:, :(s + 1) * Sr],
                         v[:, :(s + 1) * Sr], scale, kb, s * Sr, 0)
            for s in range(n_super)]
    return torch.cat(outs, dim=1)


def local_attention(q, k, v, *, scale, window, q_block=512):
    """Banded causal attention: key in (query - window, query]."""
    B, S, H, D = q.shape
    qb = max(1, math.gcd(S, q_block))
    W = window
    pad = (0, 0, 0, 0, W, 0)
    kp = torch.nn.functional.pad(k, pad)
    vp = torch.nn.functional.pad(v, pad)
    r = torch.arange(qb, device=q.device)[:, None]
    j = torch.arange(W + qb, device=q.device)[None, :]
    outs = []
    for i in range(S // qb):
        qs = q[:, i * qb:(i + 1) * qb]
        ks = kp[:, i * qb:i * qb + W + qb]
        vs = vp[:, i * qb:i * qb + W + qb]
        valid = (j > r) & (j <= W + r) & (i * qb - W + j >= 0)
        s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), ks.float()) * scale
        s = torch.where(valid[None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w.to(vs.dtype).float(), vs.float())
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def bidir_attention(q, k, v, *, scale, kv_block=1024):
    """Full bidirectional attention (encoder, cross).  q: (B,S,H,D); k, v:
    (B,T,H,D).  Dense where T <= 2 kv_block or kv_block does not divide T;
    else online over kv blocks, every row placed past the last key so that
    the causal test passes everywhere."""
    T = k.shape[1]
    if T <= 2 * kv_block or T % kv_block:
        return decode_attention(q, k, v, torch.ones(T, dtype=torch.bool, device=q.device),
                                scale)
    return _online_rows(q, k, v, scale, kv_block, q_start=T, k_start=0)


def decode_attention(q, k_cache, v_cache, mask, scale):
    """Dense attention: q (B, S, H, D), a decode step's S = 1 or all of a
    bidirectional layer's rows; cache: (B, T, H, D); mask: (B, T) or (T,)
    bool."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    if mask.dim() == 1:
        mask = mask[None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w.to(v_cache.dtype).float(), v_cache.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (params + cache)
# ---------------------------------------------------------------------------

def attn_descs(cfg: ModelConfig):
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    descs = {
        "norm": L.norm_descs(cfg),
        "wq": ParamDesc((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamDesc((d, Hkv, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDesc((d, Hkv, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDesc((H, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        descs["bq"] = ParamDesc((H, Dh), ("heads", "head_dim"), init="zeros")
        descs["bk"] = ParamDesc((Hkv, Dh), ("kv_heads", "head_dim"), init="zeros")
        descs["bv"] = ParamDesc((Hkv, Dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        descs["q_norm"] = ParamDesc((Dh,), ("head_dim",), init="ones", f32=True)
        descs["k_norm"] = ParamDesc((Dh,), ("head_dim",), init="ones", f32=True)
    return descs


def attn_cache_descs(cfg: ModelConfig, batch: int, seq: int, window: int):
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    cdt = L.compute_dtype(cfg)
    if window > 0:
        W = min(window, seq)
        return {
            "k": ParamDesc((batch, W, Hkv, Dh), ("batch", None, "kv_heads", None), dtype=cdt),
            "v": ParamDesc((batch, W, Hkv, Dh), ("batch", None, "kv_heads", None), dtype=cdt),
            "pos": ParamDesc((batch, W), ("batch", None), dtype=torch.int32),
        }
    return {
        "k": ParamDesc((batch, seq, Hkv, Dh), ("batch", "kv_seq", "kv_heads", None), dtype=cdt),
        "v": ParamDesc((batch, seq, Hkv, Dh), ("batch", "kv_seq", "kv_heads", None), dtype=cdt),
    }


def _project(cfg: ModelConfig, p, x, name: str):
    """x's projection by `w{name}` ("q", "k" or "v"), plus its bias, and
    qk-normed for q and k."""
    cdt = L.compute_dtype(cfg)
    y = torch.einsum("bsd,dhk->bshk", x, p["w" + name].to(cdt))
    if cfg.qkv_bias:
        y = y + p["b" + name].to(cdt)
    if cfg.qk_norm and name != "v":
        y = L.rms_head_norm(p[name + "_norm"], y)
    return y


def _project_qkv(cfg: ModelConfig, p, x, kv_x=None):
    """q from x; k and v from `kv_x` (the encoder's output, for
    cross-attention), or from x."""
    kv_x = x if kv_x is None else kv_x
    q, k, v = (_project(cfg, p, x, "q"), _project(cfg, p, kv_x, "k"),
               _project(cfg, p, kv_x, "v"))
    if cfg.cotangent_dtype:
        # the f32 score products would otherwise push f32 cotangents back
        # through the projections
        dt = getattr(torch, cfg.cotangent_dtype)
        q, k, v = (L.cotangent_cast(t, dt) for t in (q, k, v))
    return q, k, v


def _expand_kv(cfg: ModelConfig, k):
    """Repeat kv heads to the q-head count (head h reads kv head h // group)
    and re-annotate the sharding."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
    return constrain(k, HEADS)


def _ring_tail(t, window: int):
    """The last `window` rows of t (B, S, ...) along dim 1, the row of
    position p in slot p mod window: a roll by S mod window."""
    S = t.shape[1]
    return t[:, S - window:].roll(S % window, 1)


def _decode_per_shard(q, k, v, mask, scale):
    """`decode_attention`, local in batch and heads: under the dry run's
    rules each rank attends over its own shards (the mask (B, T) or (T,)
    whole along T)."""
    mask_axes = ("batch", None) if mask.dim() == 2 else (None,)
    return per_shard(functools.partial(decode_attention, scale=scale),
                     [HEADS] * 3 + [mask_axes], [HEADS], q, k, v, mask)


def apply_attn(cfg: ModelConfig, p, x, *, window: int, causal: bool = True,
               mode: str = "train", cache=None, pos_t=None, enc_out=None,
               cross: bool = False):
    """Returns (out, new_cache).

    Train mode is prefill without a cache (`new_cache` is None).  Decode
    writes the new token's k and v into `cache` in place (the JAX package
    returns an updated copy) and returns the same dict.  With `cross`, k
    and v come from `enc_out` (B, F, d) in train and prefill, and prefill's
    cache holds them; decode projects only q and reads that cache.
    """
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    h = L.apply_norm(cfg, p["norm"], x)

    if mode in ("train", "prefill"):
        kernel = cfg.use_pallas and not cross
        if kernel and mode == "train" and torch.is_grad_enabled():
            raise NotImplementedError(L.FORWARD_ONLY.format(kernel="flash attention"))
        q, k, v = _project_qkv(cfg, p, h, enc_out if cross else None)
        if cfg.pos_embed == "rope" and not cross:
            pos = torch.arange(S, device=x.device)[None]
            q = L.positions_for(cfg, q, pos)
            k = L.positions_for(cfg, k, pos)
        q = constrain(q, HEADS)
        if kernel:
            from repro_torch.kernels import ops as kops
            o = kops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window, scale=scale).transpose(1, 2)
        else:
            ke, ve = _expand_kv(cfg, k), _expand_kv(cfg, v)
            if cross or not causal:
                core = functools.partial(bidir_attention, scale=scale,
                                         kv_block=cfg.attn_kv_block)
            elif window > 0:
                core = functools.partial(local_attention, scale=scale, window=window,
                                         q_block=cfg.attn_q_block)
            else:
                core = functools.partial(causal_attention, scale=scale,
                                         kv_block=cfg.attn_kv_block)
            # local in batch and heads: under the dry run's rules each rank
            # attends over its own shards
            o = per_shard(core, [HEADS] * 3, [HEADS], q, ke, ve)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
        if mode == "train":
            return L.residual(x, out), None
        if window > 0 and not cross:
            # the last W positions, position p in slot p mod W: a roll by S mod W
            W = min(window, S)
            pos_c = torch.arange(S - W, S, device=x.device, dtype=torch.int32)
            # local in batch and heads (and `roll` has no DTensor strategy in
            # some torch versions): under the dry run's rules, per shard
            tail = functools.partial(_ring_tail, window=W)
            new_cache = {"k": per_shard(tail, [HEADS], [HEADS], k),
                         "v": per_shard(tail, [HEADS], [HEADS], v),
                         "pos": pos_c.roll(S % W, 0)[None].expand(B, W).contiguous()}
        else:
            new_cache = {"k": k, "v": v}
        return L.residual(x, out), new_cache

    # ---- decode: S == 1 ----
    if cache is None:
        raise ValueError("decode needs a cache")
    if cross:
        q = _project(cfg, p, h, "q")
        T = cache["k"].shape[1]
        o = _decode_per_shard(q, _expand_kv(cfg, cache["k"]), _expand_kv(cfg, cache["v"]),
                              torch.ones(T, dtype=torch.bool, device=x.device), scale)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
        return x + out, cache
    q, k, v = _project_qkv(cfg, p, h)
    pos = torch.full((B, 1), pos_t, device=x.device)
    if cfg.pos_embed == "rope":
        q = L.positions_for(cfg, q, pos)
        k = L.positions_for(cfg, k, pos)
    if window > 0:
        W = cache["k"].shape[1]
        slot = pos_t % W
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][:, slot] = pos_t
        pos_c = cache["pos"]
        mask = (pos_c >= 0) & (pos_c <= pos_t) & (pos_c > pos_t - window)
    else:
        cache["k"][:, pos_t] = k[:, 0]
        cache["v"][:, pos_t] = v[:, 0]
        T = cache["k"].shape[1]
        mask = torch.arange(T, device=x.device)[None] <= pos_t
    ke, ve = _expand_kv(cfg, cache["k"]), _expand_kv(cfg, cache["v"])
    o = _decode_per_shard(q, ke, ve, mask, scale)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    return x + out, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_descs(cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    ql, kl = cfg.mla_q_lora, cfg.mla_kv_lora
    dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {
        "norm": L.norm_descs(cfg),
        "wq_a": ParamDesc((d, ql), ("embed", "lora")),
        "q_norm": ParamDesc((ql,), ("lora",), init="ones"),
        "wq_b": ParamDesc((ql, H, dn + dr), ("lora", "heads", "head_dim")),
        "wkv_a": ParamDesc((d, kl + dr), ("embed", "lora")),
        "kv_norm": ParamDesc((kl,), ("lora",), init="ones"),
        "wk_b": ParamDesc((kl, H, dn), ("lora", "heads", "head_dim")),
        "wv_b": ParamDesc((kl, H, dv), ("lora", "heads", "head_dim")),
        "wo": ParamDesc((H, dv, d), ("heads", "head_dim", "embed")),
    }


def mla_cache_descs(cfg: ModelConfig, batch: int, seq: int):
    cdt = L.compute_dtype(cfg)
    return {
        "c_kv": ParamDesc((batch, seq, cfg.mla_kv_lora), ("batch", "kv_seq", None), dtype=cdt),
        "k_rope": ParamDesc((batch, seq, cfg.mla_rope_dim), ("batch", "kv_seq", None), dtype=cdt),
    }


def _rms_latent(x, scale):
    """The latents' RMS norm: the reciprocal RMS in f32, cast, then two
    products in x's dtype, in the reference's order."""
    r = torch.rsqrt(x.float().square().mean(dim=-1, keepdim=True) + 1e-6)
    return x * r.to(x.dtype) * scale.to(x.dtype)


def _mla_common(cfg: ModelConfig, p, h, positions):
    cdt = L.compute_dtype(cfg)
    dn, kl = cfg.mla_nope_dim, cfg.mla_kv_lora
    cq = _rms_latent(torch.matmul(h, p["wq_a"].to(cdt)), p["q_norm"])
    qf = torch.einsum("bsl,lhk->bshk", cq, p["wq_b"].to(cdt))
    q_nope, q_rope = qf[..., :dn], L.apply_rope(cfg, qf[..., dn:], positions)
    ckv_f = torch.matmul(h, p["wkv_a"].to(cdt))
    c_kv = _rms_latent(ckv_f[..., :kl], p["kv_norm"])
    k_rope = L.apply_rope(cfg, ckv_f[:, :, None, kl:], positions)[:, :, 0]
    q_nope = constrain(q_nope, ("batch", None, "heads", None))
    return q_nope, q_rope, c_kv, k_rope


def apply_mla(cfg: ModelConfig, p, x, *, mode="train", cache=None, pos_t=None):
    """Returns (out, new_cache).

    Train and prefill expand the latent kv through `wk_b` / `wv_b`, append
    the shared rope key to every head, and run `causal_attention` with q/k
    of width nope + rope and v of width v_dim, scaled by 1/sqrt(nope +
    rope).  Prefill returns the latent cache {"c_kv", "k_rope"}.  Decode
    (S == 1) writes the new latent row into `cache` in place and attends
    with W_k absorbed into the query: scores over `c_kv` plus the rope
    scores, both f32 products, masked to positions <= pos_t; the weighted
    latent is cast to the compute dtype, then `wv_b` and `wo`.
    """
    cdt = L.compute_dtype(cfg)
    B, S, _ = x.shape
    dn, dr = cfg.mla_nope_dim, cfg.mla_rope_dim
    scale = 1.0 / math.sqrt(dn + dr)
    h = L.apply_norm(cfg, p["norm"], x)

    if mode in ("train", "prefill"):
        pos = torch.arange(S, device=x.device)[None]
        q_nope, q_rope, c_kv, k_rope = _mla_common(cfg, p, h, pos)
        k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["wk_b"].to(cdt))
        v = torch.einsum("bsl,lhk->bshk", c_kv, p["wv_b"].to(cdt))
        k_nope = constrain(k_nope, ("batch", None, "heads", None))
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, cfg.n_heads, dr)], dim=-1)
        o = per_shard(functools.partial(causal_attention, scale=scale,
                                        kv_block=cfg.attn_kv_block),
                      [HEADS] * 3, [HEADS], q, k, v)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
        new_cache = {"c_kv": c_kv, "k_rope": k_rope} if mode == "prefill" else None
        return L.residual(x, out), new_cache

    # ---- absorbed decode: S == 1 ----
    if cache is None:
        raise ValueError("decode needs a cache")
    pos = torch.full((B, 1), pos_t, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_common(cfg, p, h, pos)
    cache["c_kv"][:, pos_t] = c_kv_new[:, 0]
    cache["k_rope"][:, pos_t] = k_rope_new[:, 0]
    ckv, krp = cache["c_kv"], cache["k_rope"]
    T = ckv.shape[1]
    q_eff = torch.einsum("bshk,lhk->bshl", q_nope, p["wk_b"].to(cdt))
    s = (torch.einsum("bshl,btl->bhst", q_eff.float(), ckv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), krp.float())) * scale
    s = torch.where(torch.arange(T, device=x.device) <= pos_t, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhst,btl->bshl", w.to(cdt).float(), ckv.float()).to(cdt)
    o = torch.einsum("bshl,lhk->bshk", o_c, p["wv_b"].to(cdt))
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cdt))
    return x + out, cache
