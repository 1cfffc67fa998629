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
points; they act only under the dry run's axis rules.  Under those rules
two partitions of the port's own stand where the annotations alone would
replicate the work (XLA partitions the same dots by itself):

* heads that do not divide the model axis (qwen2's 12, granite's 24, ...)
  leave q, k and v whole on every model rank.  Train and prefill then keep
  the layer sequence-parallel: each rank projects and attends its own
  block of query rows against the batch shard's whole k and v, gathered
  over the model axis before the kv heads are repeated.  A causal layer
  trades the second half of its rows with the rank at the mirrored
  coordinate (zigzag), so that every rank scores as many keys;
* decode over a cache sharded along T scores each rank's slice of the
  unexpanded cache and merges the partial softmaxes exactly
  (`_merge_partials`), for GQA and for MLA's latent cache; the new row is
  written only by the rank that holds it (`sharding.write_row`).
"""
from __future__ import annotations

import functools
import logging
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import active_rules, constrain, per_shard, write_row
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDesc

NEG_INF = -1e30
HEADS = ("batch", None, "heads", None)   # q, k, v and o: (B, S, H, D)
ROWS = ("batch", "seq_act", None, None)  # a rank's query rows, all heads
ROWS_D = ("batch", "seq_act", None)      # the same rows, model width
WHOLE = ("batch", None, None, None)      # k and v whole along the sequence
CACHE = ("batch", "kv_seq", "kv_heads", None)
LATENT = ("batch", "kv_seq", None)       # MLA's latent cache (B, T, L)

log = logging.getLogger(__name__)


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


def causal_attention(q, k, v, *, scale, n_super=8, kv_block=512, q_start=0):
    """Exact causal attention, super-row blocked.  q: (B, S, H, D), the rows
    at positions q_start .. q_start + S - 1; k, v: (B, T, H, D) from
    position 0, T >= q_start + S (S == T by default).  q_start is a
    multiple of S's row bands."""
    S = q.shape[1]
    n_super = max(1, min(n_super, S // max(1, kv_block)))
    while S % n_super:
        n_super -= 1
    Sr = S // n_super
    kb = math.gcd(Sr, kv_block)
    end = q_start + Sr
    outs = [_online_rows(q[:, s * Sr:(s + 1) * Sr], k[:, :end + s * Sr],
                         v[:, :end + s * Sr], scale, kb, q_start + s * Sr, 0)
            for s in range(n_super)]
    return torch.cat(outs, dim=1)


def local_attention(q, k, v, *, scale, window, q_block=512, q_start=0):
    """Banded causal attention: key in (query - window, query].  q: the
    rows at positions q_start .. q_start + S - 1; k, v from position 0."""
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
        a = q_start + i * qb
        qs = q[:, i * qb:(i + 1) * qb]
        ks = kp[:, a:a + W + qb]
        vs = vp[:, a:a + W + qb]
        valid = (j > r) & (j <= W + r) & (a - W + j >= 0)
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
    return constrain(_repeat_kv(k, cfg.n_heads // cfg.n_kv_heads), HEADS)


def _repeat_kv(k, group: int):
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def _ring_tail(t, window: int):
    """The last `window` rows of t (B, S, ...) along dim 1, the row of
    position p in slot p mod window: a roll by S mod window."""
    S = t.shape[1]
    return t[:, S - window:].roll(S % window, 1)


def _decode_per_shard(q, k, v, mask, scale):
    """`decode_attention` over a cache that is whole along T (the ring, the
    cross-attention's frames), local in batch and heads: under the dry
    run's rules each rank attends over its own shards."""
    mask_axes = ("batch", None) if mask.dim() == 2 else (None,)
    return per_shard(functools.partial(decode_attention, scale=scale),
                     [HEADS] * 3 + [mask_axes], [HEADS], q, k, v, mask)


# ---------------------------------------------------------------------------
# the port's own partitions under the dry run's rules
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _say_replicated(rows: int, n: int, axis: str, heads: int):
    log.warning("attention: %d query rows do not split evenly over the %d ranks of %r; "
                "each rank attends all %d heads of them", rows, n, axis, heads)


def _row_axis(cfg: ModelConfig, x, *, kind: str):
    """The mesh axis whose ranks split a train or prefill layer's query
    rows: under the dry run's rules, when the heads do not shard over it
    and the activations' sequence does (`seq_act`).  None otherwise, and
    for a sequence that does not cut into n equal blocks (2 n for a causal
    layer's zigzag), which keeps the replicated path and says so."""
    r = active_rules(x)
    if r is None or r.spec(("heads",), (cfg.n_heads,)):
        return None
    axis = r.rules.get("seq_act")
    n = r.mesh_shape.get(axis, 1) if isinstance(axis, str) else 1
    if n <= 1:
        return None
    S = x.shape[1]
    if S % (2 * n if kind == "causal" else n):
        _say_replicated(S, n, axis, cfg.n_heads)
        return None
    return axis


def _trade(t, peer: int, n: int, group: str):
    """t (B, R, ...) sent to the rank at coordinate `peer` of `group` (n
    ranks), whose t comes back: one all-to-all with one non-empty split each
    way (a pairwise exchange; differentiable)."""
    from torch.distributed import _functional_collectives as funcol

    rows = t.transpose(0, 1).contiguous()
    splits = [0] * n
    splits[peer] = rows.shape[0]
    out = funcol.all_to_all_single_autograd(rows, splits, splits, group)
    return funcol.wait_tensor(out).transpose(0, 1)


def _core(kind: str, *, scale, window, kv_block, q_block):
    """The plain attention core of a layer: "causal", "local" (windowed) or
    "bidir"."""
    if kind == "bidir":
        return functools.partial(bidir_attention, scale=scale, kv_block=kv_block)
    if kind == "local":
        return functools.partial(local_attention, scale=scale, window=window, q_block=q_block)
    return functools.partial(causal_attention, scale=scale, kv_block=kv_block)


def _attend_rows(q, k, v, *, kind, coord, n, group, heads_per_kv, scale, kv_block,
                 q_block, window):
    """One rank's block of query rows, q (B, Sl, H, D), the block at
    coordinate `coord` of `n` along the sequence, against the batch
    shard's whole k, v (B, T, Hkv, D), the kv heads repeated here.

    A causal layer keeps the first half of its rows and trades the second
    half with the rank at coordinate n - 1 - coord (`group`'s all-to-all),
    so that each rank scores the rows of one early and one late half-block:
    the same number of keys on every rank.  The outputs of the traded rows
    go back the same way."""
    k, v = _repeat_kv(k, heads_per_kv), _repeat_kv(v, heads_per_kv)
    core = _core(kind, scale=scale, window=window, kv_block=kv_block, q_block=q_block)
    Sl = q.shape[1]
    if kind == "bidir":
        return core(q, k, v)
    if kind == "local":
        return core(q, k, v, q_start=coord * Sl)
    half, peer = Sl // 2, n - 1 - coord
    lo = core(q[:, :half], k, v, q_start=coord * Sl)
    hi = core(_trade(q[:, half:], peer, n, group), k, v, q_start=peer * Sl + half)
    return torch.cat([lo, _trade(hi, peer, n, group)], dim=1)


def _project_local(x, *ws, cfg: ModelConfig, names, which, rope_start):
    """`_project` of each of `which` from one rank's rows of x, with the
    weights `ws` (named `names`) whole; rotary positions from `rope_start`
    (None: none)."""
    p = dict(zip(names, ws))
    ys = [_project(cfg, p, x, n) for n in which]
    if cfg.cotangent_dtype:
        ys = [L.cotangent_cast(y, getattr(torch, cfg.cotangent_dtype)) for y in ys]
    if rope_start is not None:
        pos = torch.arange(rope_start, rope_start + x.shape[1], device=x.device)[None]
        ys = [y if n == "v" else L.positions_for(cfg, y, pos) for n, y in zip(which, ys)]
    return tuple(ys)


def _project_rows(cfg: ModelConfig, p, x, which: str, *, axis: str, rope: bool):
    """The projections `which` of x, each rank projecting its own rows
    along `axis` (DTensor's own products would flatten the sharded rows
    into the batch, which some torch versions refuse)."""
    r = active_rules(x)
    names = sorted(n for n in p if n not in ("norm", "wo"))
    descs = attn_descs(cfg)
    start = r.mesh.get_local_rank(axis) * (x.shape[1] // r.mesh_shape[axis]) if rope else None
    fn = functools.partial(_project_local, cfg=cfg, names=tuple(names), which=which,
                           rope_start=start)
    return per_shard(fn, [ROWS_D] + [descs[n].axes for n in names], [ROWS] * len(which),
                     x, *(p[n] for n in names))


def _out_rows(o, wo):
    return torch.einsum("bshk,hkd->bsd", o, wo.to(o.dtype))


def _rows_attention(cfg: ModelConfig, q, k, v, *, axis: str, kind: str, scale, window):
    """Attention partitioned by query rows over mesh axis `axis`: each rank
    attends its own rows (`_attend_rows`) against k and v gathered whole
    along the sequence, before the kv heads are repeated; the output stays
    sequence-sharded."""
    r = active_rules(q)
    fn = functools.partial(
        _attend_rows, kind=kind, coord=r.mesh.get_local_rank(axis), n=r.mesh_shape[axis],
        group=r.mesh.get_group(axis).group_name, heads_per_kv=cfg.n_heads // cfg.n_kv_heads,
        scale=scale, kv_block=cfg.attn_kv_block, q_block=cfg.attn_q_block, window=window)
    return per_shard(fn, [ROWS, WHOLE, WHOLE], [ROWS], q, k, v)


def _merge_partials(m, l, o, group: str, n: int):
    """The exact softmax over the union of the ranks' key slices, from one
    all-gather of each rank's partial (m, l, o) over `group` (n ranks):
    o = sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r, M = max_r m_r.
    m, l: (B, H, Q) f32; o: (B, H, Q, Dv) f32, unnormalised."""
    c10d = torch.ops._c10d_functional
    part = torch.cat([m[..., None], l[..., None], o], dim=-1)
    part = c10d.wait_tensor(c10d.all_gather_into_tensor(part.contiguous(), n, group))
    part = part.view(n, *o.shape[:-1], -1)
    ms, ls = part[..., 0], part[..., 1]
    w = torch.exp(ms - ms.amax(dim=0))
    return (w[..., None] * part[..., 2:]).sum(dim=0) / (w * ls).sum(dim=0)[..., None]


def _partial_softmax(s, mask):
    """Masked f32 scores (..., T) and a mask (B, T) -> (m, l, p): the rows'
    max, the sum of p = e^(s - m), and p."""
    s = torch.where(mask.view(mask.shape[0], *[1] * (s.dim() - 2), -1), s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), p


def _decode_slice(q, k, v, mask, *, scale, group, n):
    """One rank's share of a decode step over a cache sharded along T: q
    (B, 1, H, D) against its slice k, v (B, Tl, Hkv, D) and mask (B, Tl)
    or (Tl,), q head h reading kv head h // (H / Hkv) (no repeated copy of
    the cache), merged with the other slices (`_merge_partials`)."""
    B, Q, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().view(B, Q, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    m, l, p = _partial_softmax(s, mask if mask.dim() == 2 else mask[None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = _merge_partials(m.reshape(B, H, Q), l.reshape(B, H, Q), o.reshape(B, H, Q, -1), group, n)
    return o.transpose(1, 2).to(q.dtype)


def _t_axis(r, cache, axes):
    """The mesh axis that shards a cache's T (dim 1) under rules `r`."""
    spec = r.spec(axes, cache.shape)
    return spec[1] if len(spec) > 1 and isinstance(spec[1], str) else None


def _decode(cfg: ModelConfig, q, k, v, mask, scale):
    """`decode_attention` of q (B, 1, H, D) over a cache (B, T, Hkv, D).

    Under the dry run's rules, a cache sharded along T is scored where it
    lies: each rank takes its slice of the unexpanded cache and of the
    mask, with all q heads (or its own, where the q and kv heads shard over
    one axis), and the partial softmaxes are merged over the T axis
    (split-T).  Otherwise the kv heads are repeated and each rank attends
    over its own shards of batch and heads."""
    r = active_rules(q, k)
    axis = None if r is None else _t_axis(r, k, CACHE)
    if axis is None:
        return _decode_per_shard(q, _expand_kv(cfg, k), _expand_kv(cfg, v), mask, scale)
    sq, sk = r.spec(HEADS, q.shape), r.spec(CACHE, k.shape)
    local_heads = len(sq) > 2 and len(sk) > 2 and sq[2] is not None and sq[2] == sk[2]
    qa = HEADS if local_heads else WHOLE
    ka = CACHE if local_heads else ("batch", "kv_seq", None, None)
    fn = functools.partial(_decode_slice, scale=scale, group=r.mesh.get_group(axis).group_name,
                           n=r.mesh_shape[axis])
    mask_axes = ("batch", "kv_seq") if mask.dim() == 2 else ("kv_seq",)
    return per_shard(fn, [qa, ka, ka, mask_axes], [qa], q, k, v, mask)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

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

    if mode in ("train", "prefill"):
        kernel = cfg.use_pallas and not cross
        if kernel and mode == "train" and torch.is_grad_enabled():
            raise NotImplementedError(L.FORWARD_ONLY.format(kernel="flash attention"))
        kind = "bidir" if cross or not causal else "local" if window > 0 else "causal"
        axis = None if kernel else _row_axis(cfg, x, kind=kind)
        if axis is not None:
            # the query rows split: the norm's output stays sharded along
            # them, and each rank projects, attends and projects back its own
            h = L.apply_norm(cfg, p["norm"], x, axes=ROWS_D)
            rope = cfg.pos_embed == "rope" and not cross
            q, = _project_rows(cfg, p, h, "q", axis=axis, rope=rope)
            k, v = _project_rows(cfg, p, enc_out if cross else h, "kv", axis=axis, rope=rope)
            o = _rows_attention(cfg, q, k, v, axis=axis, kind=kind, scale=scale, window=window)
            out = per_shard(_out_rows, [ROWS, ("heads", "head_dim", "embed")], [ROWS_D],
                            o, p["wo"])
        else:
            h = L.apply_norm(cfg, p["norm"], x)
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
                core = _core(kind, scale=scale, window=window, kv_block=cfg.attn_kv_block,
                             q_block=cfg.attn_q_block)
                # local in batch and heads: under the dry run's rules each rank
                # attends over its own shards
                o = per_shard(core, [HEADS] * 3, [HEADS], q, _expand_kv(cfg, k),
                              _expand_kv(cfg, v))
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
    h = L.apply_norm(cfg, p["norm"], x)
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
        write_row(cache["k"], slot, k[:, 0])
        write_row(cache["v"], slot, v[:, 0])
        write_row(cache["pos"], slot, pos_t)
        pos_c = cache["pos"]
        mask = (pos_c >= 0) & (pos_c <= pos_t) & (pos_c > pos_t - window)
        # the ring is whole along its slots
        o = _decode_per_shard(q, _expand_kv(cfg, cache["k"]), _expand_kv(cfg, cache["v"]),
                              mask, scale)
    else:
        write_row(cache["k"], pos_t, k[:, 0])
        write_row(cache["v"], pos_t, v[:, 0])
        T = cache["k"].shape[1]
        mask = torch.arange(T, device=x.device)[None] <= pos_t
        o = _decode(cfg, q, cache["k"], cache["v"], mask, scale)
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
        "c_kv": ParamDesc((batch, seq, cfg.mla_kv_lora), LATENT, dtype=cdt),
        "k_rope": ParamDesc((batch, seq, cfg.mla_rope_dim), LATENT, dtype=cdt),
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
    write_row(cache["c_kv"], pos_t, c_kv_new[:, 0])
    write_row(cache["k_rope"], pos_t, k_rope_new[:, 0])
    ckv, krp = cache["c_kv"], cache["k_rope"]
    T = ckv.shape[1]
    mask = torch.arange(T, device=x.device) <= pos_t
    q_eff = torch.einsum("bshk,lhk->bshl", q_nope, p["wk_b"].to(cdt))
    r = active_rules(q_eff, ckv)
    axis = None if r is None else _t_axis(r, ckv, LATENT)
    if axis is None:
        s = (torch.einsum("bshl,btl->bhst", q_eff.float(), ckv.float())
             + torch.einsum("bshr,btr->bhst", q_rope.float(), krp.float())) * scale
        s = torch.where(mask, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o_c = torch.einsum("bhst,btl->bshl", w.to(cdt).float(), ckv.float()).to(cdt)
    else:
        # split-T over the latent cache, all heads on each rank's slice
        fn = functools.partial(_mla_slice, scale=scale, group=r.mesh.get_group(axis).group_name,
                               n=r.mesh_shape[axis])
        o_c = per_shard(fn, [WHOLE, WHOLE, LATENT, LATENT, ("kv_seq",)], [WHOLE],
                        q_eff, q_rope, ckv, krp, mask).to(cdt)
    o = torch.einsum("bshl,lhk->bshk", o_c, p["wv_b"].to(cdt))
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cdt))
    return x + out, cache


def _mla_slice(q_eff, q_rope, ckv, krp, mask, *, scale, group, n):
    """The absorbed decode's attention on one rank's slice of the latent
    cache (B, Tl, L) and (B, Tl, R), merged with the other slices: the
    weighted latent (B, 1, H, L) in f32."""
    s = (torch.einsum("bshl,btl->bhst", q_eff.float(), ckv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), krp.float())) * scale
    m, l, p = _partial_softmax(s, mask[None])
    o = torch.einsum("bhst,btl->bhsl", p.to(ckv.dtype).float(), ckv.float())
    return _merge_partials(m, l, o, group, n).transpose(1, 2)
