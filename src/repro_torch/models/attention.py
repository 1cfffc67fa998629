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
  coordinate (zigzag), so that every rank scores as many keys.  A
  bidirectional layer whose rows (or keys) do not split evenly (whisper's
  1500 frames) is padded to a multiple of the axis, and the padded keys
  are cut off before the scores;
* q heads that shard when the kv heads do not (stablelm's 32 / 8,
  recurrentgemma's 16 / 1 on 16 ranks): each rank projects only the kv
  heads its own q heads read and picks them per q head locally, never
  the whole repeated k and v; a prefill's cache rows come from one
  all-to-all of those heads;
* MLA's down projections (`wq_a`, `wkv_a`) read each rank's own rows of
  the sequence-sharded norm output; the narrow latents are gathered;
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
from repro_torch.distributed.sharding import (active_rules, constrain, partial_grad, per_shard,
                                             write_row)
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDesc
from repro_torch.models.spans import span

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
    # the kv blocks as one split: its gradient is one `cat` of the blocks'
    # gradients, where a slice per block gives each a zero-padded gradient of
    # the whole band, summed
    kbs, vbs = kt.split(kv_block, dim=2), vt.split(kv_block, dim=2)
    for j in range(nk):
        cols = k_start + j * kv_block + torch.arange(kv_block, device=q_band.device)
        s = torch.matmul(qt, kbs[j].transpose(-1, -2)) * scale
        s = torch.where(cols[None, None, None, :] <= rows[None, None, :, None],
                        s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(vt.dtype).float(), vbs[j].float())
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


def _ring_tail(t, window: int, length: int):
    """The last `window` rows of t (B, R, ...) along dim 1, the rows of
    positions length - R .. length - 1, the row of position p in slot
    p mod window: a roll by length mod window."""
    return t[:, t.shape[1] - window:].roll(length % window, 1)


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


def _seq_axis(x):
    """The mesh axis that shards the activations' sequence (`seq_act`) under
    the dry run's rules, with its size; (None, 1) otherwise."""
    r = active_rules(x)
    axis = None if r is None else r.rules.get("seq_act")
    n = r.mesh_shape.get(axis, 1) if isinstance(axis, str) else 1
    return (axis, n) if n > 1 else (None, 1)


def _row_axis(cfg: ModelConfig, x, *, kind: str):
    """The mesh axis whose ranks split a train or prefill layer's query
    rows: under the dry run's rules, when the heads do not shard over it
    and the activations' sequence does (`seq_act`).  None otherwise, and
    for a causal or local sequence that does not cut into n equal blocks
    (2 n for a causal layer's zigzag), which keeps the replicated path and
    says so; a bidirectional layer's rows are padded instead
    (`_split_rows`)."""
    r = active_rules(x)
    if r is None or r.spec(("heads",), (cfg.n_heads,)):
        return None
    axis, n = _seq_axis(x)
    if axis is None:
        return None
    S = x.shape[1]
    if kind != "bidir" and S % (2 * n if kind == "causal" else n):
        _say_replicated(S, n, axis, cfg.n_heads)
        return None
    return axis


def _whole_rows(t, rows: int):
    """The first `rows` rows of t (B, R, ...) along dim 1, whole on every
    rank: under the dry run's rules a row-sharded t is gathered first."""
    axes = ("batch",) + (None,) * (t.dim() - 1)
    return per_shard(lambda u: u[:, :rows], [axes], [axes], t)


def _split_rows(t, n: int):
    """t (B, R, d) laid out by rows (`ROWS_D`), padded with zero rows to a
    multiple of n where n does not divide R (DTensor splits a dim only
    evenly); the caller cuts the padded rows off (`_whole_rows`)."""
    pad = -t.shape[1] % n
    if pad:
        axes = ("batch", None, None)
        t = per_shard(lambda u: torch.nn.functional.pad(u, (0, 0, 0, pad)), [axes], [axes], t)
    return constrain(t, ROWS_D)


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
                 q_block, window, kv_len):
    """One rank's block of query rows, q (B, Sl, H, D), the block at
    coordinate `coord` of `n` along the sequence, against the batch
    shard's whole k, v (B, T, Hkv, D), cut to their first `kv_len` rows
    (the rest padding), the kv heads repeated here.

    A causal layer keeps the first half of its rows and trades the second
    half with the rank at coordinate n - 1 - coord (`group`'s all-to-all),
    so that each rank scores the rows of one early and one late half-block:
    the same number of keys on every rank.  The outputs of the traded rows
    go back the same way."""
    k, v = k[:, :kv_len], v[:, :kv_len]
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


def _rows_start(r, x, axes) -> int:
    """The position of this rank's first row of x (B, S, ...) laid out by
    `axes` under rules `r` (0 where dim 1 is whole)."""
    spec = r.spec(axes, x.shape)
    axis = spec[1] if len(spec) > 1 else None
    if not isinstance(axis, str):
        return 0
    return r.mesh.get_local_rank(axis) * (x.shape[1] // r.mesh_shape[axis])


def _project_rows(cfg: ModelConfig, p, x, which: str, *, rope: bool, axes=ROWS_D):
    """The projections `which` of x, each rank projecting its own rows as
    `axes` lay them out (DTensor's own products would flatten the sharded
    rows into the batch, which some torch versions refuse)."""
    r = active_rules(x)
    names = sorted(n for n in p if n not in ("norm", "wo"))
    descs = attn_descs(cfg)
    fn = functools.partial(_project_local, cfg=cfg, names=tuple(names), which=which,
                           rope_start=_rows_start(r, x, axes) if rope else None)
    return per_shard(fn, [axes] + [descs[n].axes for n in names], [axes + (None,)] * len(which),
                     x, *(p[n] for n in names))


def _out_rows(o, wo):
    return torch.einsum("bshk,hkd->bsd", o, wo.to(o.dtype))


def _rows_attention(cfg: ModelConfig, q, k, v, *, axis: str, kind: str, scale, window,
                    kv_len: int):
    """Attention partitioned by query rows over mesh axis `axis`: each rank
    attends its own rows (`_attend_rows`) against k and v gathered whole
    along the sequence and cut to `kv_len` rows, before the kv heads are
    repeated; the output stays sequence-sharded."""
    r = active_rules(q)
    fn = functools.partial(
        _attend_rows, kind=kind, coord=r.mesh.get_local_rank(axis), n=r.mesh_shape[axis],
        group=r.mesh.get_group(axis).group_name, heads_per_kv=cfg.n_heads // cfg.n_kv_heads,
        scale=scale, kv_block=cfg.attn_kv_block, q_block=cfg.attn_q_block, window=window,
        kv_len=kv_len)
    return per_shard(fn, [ROWS, WHOLE, WHOLE], [ROWS], q, k, v)


# ---- q heads sharded, kv heads whole ----

def _kv_head_axis(cfg: ModelConfig, x):
    """The mesh axis over which the q heads shard while the kv heads do not
    (stablelm-12b's 32 / 8 heads on 16 ranks), under the dry run's rules;
    None otherwise."""
    r = active_rules(x)
    if r is None or cfg.n_heads == cfg.n_kv_heads:
        return None
    sq = r.spec(("heads",), (cfg.n_heads,))
    if not sq or not isinstance(sq[0], str) or r.spec(("kv_heads",), (cfg.n_kv_heads,)):
        return None
    return sq[0]


def _own_kv_heads(cfg: ModelConfig, coord: int, n: int):
    """(first, count, pick): the kv heads that the q heads of the rank at
    coordinate `coord` of the `n` that split the q heads read, q head h
    reading kv head h // (Hq / Hkv): from `first`, `count` of them; `pick`
    indexes them per local q head."""
    hl, group = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    heads = torch.arange(coord * hl, (coord + 1) * hl) // group
    first = int(heads[0])
    return first, int(heads[-1]) - first + 1, heads - first


def _pick_heads(t, pick):
    """t (B, S, count, D) -> (B, S, len(pick), D), one kv head per local q
    head: a broadcast view where the rank reads one kv head."""
    if t.shape[2] == 1:
        return t.expand(-1, -1, len(pick), -1)
    return t.index_select(2, pick.to(t.device))


def _cache_rows(k, v, first: int, *, cfg: ModelConfig, coord: int, n: int, group: str):
    """A prefill cache's rows for this rank, every kv head, from the kv
    heads each rank projected for its own q heads (k, v (B, S, count, D)
    from kv head `first`): one all-to-all over `group`, in which each kv
    head's rows go out from the first rank whose q heads read it, block j
    of S / n rows to the rank at coordinate j.  -> (B, S / n, Hkv, D) each."""
    from torch.distributed import _functional_collectives as funcol

    hl, g = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    owner = [h * g // hl for h in range(cfg.n_kv_heads)]
    mine = [h - first for h, o in enumerate(owner) if o == coord]
    B, S, _, D = k.shape
    kv = torch.stack([k, v])[:, :, :, mine]                     # (2, B, S, o, D)
    send = kv.reshape(2, B, n, S // n, len(mine), D).permute(2, 4, 0, 1, 3, 5)
    send = send.reshape(n * len(mine), 2 * B * (S // n) * D).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(
        send, [owner.count(j) for j in range(n)], [len(mine)] * n, group))
    got = got.view(cfg.n_kv_heads, 2, B, S // n, D).permute(1, 2, 3, 0, 4)
    return got[0], got[1]


def _attend_own_heads(q, *args, cfg, core, coord, n, names, rope, group=None):
    """One rank's q heads, q (B, S, hl, D), against the kv heads they read.
    With `names`, args are the kv source (B, T, d), with `group` a
    row-sharded copy of it (only its layout is read), and the weights so
    named; only those kv heads are projected here, and with `group` the
    prefill cache's rows of this rank come back too (`_cache_rows`).
    Otherwise args are k and v with every kv head."""
    first, count, pick = _own_kv_heads(cfg, coord, n)
    if not names:
        k, v = args
        return core(q, _pick_heads(k, pick), _pick_heads(v, pick))
    src, ws = args[0], dict(zip(names, args[1 + (group is not None):]))
    own = {m: (w[first:first + count] if m in ("bk", "bv") else
               w[:, first:first + count] if m in ("wk", "wv") else w)
           for m, w in ws.items()}
    k, v = _project_local(src, *own.values(), cfg=cfg, names=tuple(own), which="kv",
                          rope_start=0 if rope else None)
    o = core(q, _pick_heads(k, pick), _pick_heads(v, pick))
    if group is None:
        return o
    return (o,) + _cache_rows(k, v, first, cfg=cfg, coord=coord, n=n, group=group)


def _cache_kv(cfg: ModelConfig, p, src, *, window: int, rope: bool):
    """A prefill's cache k and v, every kv head, from src (B, S, d), whole
    along the sequence: its last `window` positions for a ring, else each
    rank's own rows of the cache's layout."""
    S = src.shape[1]
    if window > 0:
        W = min(window, S)
        tail = src[:, S - W:]
        k, v = _project(cfg, p, tail, "k"), _project(cfg, p, tail, "v")
        if rope:
            k = L.positions_for(cfg, k, torch.arange(S - W, S, device=src.device)[None])
        return k, v
    return _project_rows(cfg, p, src, "kv", rope=rope, axes=CACHE[:2] + (None,))


def _heads_attention(cfg: ModelConfig, p, q, h, k, v, *, axis: str, core, rope: bool,
                     cache: bool = False):
    """Attention whose q heads shard over `axis` while the kv heads do not:
    each rank attends its own q heads against only the kv heads they read.
    With more than one kv head, it projects just those from h (B, S, d),
    whole along the sequence (k and v are then None); with one, the whole
    k and v are given, and each rank reads its head through a view.

    With `cache` (a prefill's, more than one kv head), also returns the
    cache's k and v, every kv head: where the cache's rows shard over
    `axis` too, traded from the heads projected here (`_cache_rows`), else
    projected again (`_cache_kv`)."""
    r = active_rules(q)
    fn = functools.partial(_attend_own_heads, cfg=cfg, core=core,
                           coord=r.mesh.get_local_rank(axis), n=r.mesh_shape[axis],
                           names=(), rope=rope)
    if k is not None:
        return per_shard(fn, [HEADS, WHOLE, WHOLE], [HEADS], q, k, v)
    names = tuple(sorted(m for m in p if m in ("wk", "wv", "bk", "bv", "k_norm")))
    descs = attn_descs(cfg)
    rows = ("batch", "kv_seq", None)
    trade = cache and _t_axis(r, h, rows) == axis
    donor = [h] if trade else []
    if trade:
        fn = functools.partial(fn, group=r.mesh.get_group(axis).group_name)
    out = per_shard(functools.partial(fn, names=names),
                    [HEADS, ("batch", None, None)] + [rows] * trade
                    + [descs[m].axes for m in names],
                    [HEADS] + [rows + (None,)] * (2 * trade), q, h, *donor,
                    *(p[m] for m in names))
    if trade or not cache:
        return out
    return (out,) + _cache_kv(cfg, p, h, window=0, rope=rope)


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
        rope = cfg.pos_embed == "rope" and not cross
        if axis is not None:
            # the query rows split: the norm's output stays sharded along
            # them, and each rank projects, attends and projects back its own
            n = active_rules(x).mesh_shape[axis]
            with span("repro.attn.qkv"):
                h = _split_rows(L.apply_norm(cfg, p["norm"], x, axes=ROWS_D), n)
                kv_src = _split_rows(enc_out, n) if cross else h
                q, = _project_rows(cfg, p, h, "q", rope=rope)
                k, v = _project_rows(cfg, p, kv_src, "kv", rope=rope)
            T = (enc_out if cross else x).shape[1]
            with span("repro.attn.core"):
                o = _rows_attention(cfg, q, k, v, axis=axis, kind=kind, scale=scale,
                                    window=window, kv_len=T)
            with span("repro.attn.out"):
                out = per_shard(_out_rows, [ROWS, ("heads", "head_dim", "embed")], [ROWS_D],
                                o, p["wo"])
                if h.shape[1] != S:
                    out = _whole_rows(out, S)
            if mode == "prefill" and k.shape[1] != T:
                k, v = _whole_rows(k, T), _whole_rows(v, T)
        else:
            kv_axis = None if kernel else _kv_head_axis(cfg, x)
            core = _core(kind, scale=scale, window=window, kv_block=cfg.attn_kv_block,
                         q_block=cfg.attn_q_block)
            own_kv = kv_axis is not None and cfg.n_kv_heads > 1
            with span("repro.attn.qkv"):
                h = L.apply_norm(cfg, p["norm"], x)
                if own_kv:
                    # each rank projects only the kv heads its q heads read
                    # (inside the attention below)
                    q, = _project_local(h, *p.values(), cfg=cfg, names=tuple(p), which="q",
                                        rope_start=0 if rope else None)
                    # the kv heads' `per_shard` passes its gradient of h back
                    # whole, q's product as a partial sum: summed as one
                    kv_src = enc_out if cross else partial_grad(h, "heads")
                else:
                    # one kv head whole on every rank (`kv_axis`): its products
                    # pass their gradient of h back whole, q's as a partial sum
                    kv_x = enc_out if cross else partial_grad(h, "heads") if kv_axis else None
                    q, k, v = _project_qkv(cfg, p, h, kv_x)
                    if rope:
                        pos = torch.arange(S, device=x.device)[None]
                        q = L.positions_for(cfg, q, pos)
                        k = L.positions_for(cfg, k, pos)
                q = constrain(q, HEADS)
            with span("repro.attn.core"):
                if own_kv:
                    ring = window > 0 and not cross
                    o = _heads_attention(cfg, p, q, kv_src, None, None,
                                         axis=kv_axis, core=core, rope=rope,
                                         cache=mode == "prefill" and not ring)
                    if mode == "prefill" and not ring:
                        o, k, v = o
                    elif mode == "prefill":
                        k, v = _cache_kv(cfg, p, kv_src, window=window, rope=rope)
                elif kernel:
                    from repro_torch.kernels import ops as kops
                    o = kops.flash_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, scale=scale).transpose(1, 2)
                elif kv_axis is not None:
                    # one kv head, whole on every rank: read through a view
                    o = _heads_attention(cfg, p, q, None, k, v, axis=kv_axis, core=core,
                                         rope=rope)
                else:
                    # local in batch and heads: under the dry run's rules each
                    # rank attends over its own shards
                    o = per_shard(core, [HEADS] * 3, [HEADS], q, _expand_kv(cfg, k),
                                  _expand_kv(cfg, v))
            with span("repro.attn.out"):
                out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
        if mode == "train":
            return L.residual(x, out), None
        if window > 0 and not cross:
            # the last W positions, position p in slot p mod W: a roll by S mod W
            W = min(window, S)
            pos_c = torch.arange(S - W, S, device=x.device, dtype=torch.int32)
            # local in batch and heads (and `roll` has no DTensor strategy in
            # some torch versions): under the dry run's rules, per shard
            tail = functools.partial(_ring_tail, window=W, length=S)
            new_cache = {"k": per_shard(tail, [HEADS], [HEADS], k),
                         "v": per_shard(tail, [HEADS], [HEADS], v),
                         "pos": pos_c.roll(S % W, 0)[None].expand(B, W).contiguous()}
        else:
            new_cache = {"k": k, "v": v}
        return L.residual(x, out), new_cache

    # ---- decode: S == 1 ----
    if cache is None:
        raise ValueError("decode needs a cache")
    with span("repro.attn.qkv"):
        h = L.apply_norm(cfg, p["norm"], x)
        if cross:
            q = _project(cfg, p, h, "q")
        else:
            q, k, v = _project_qkv(cfg, p, h)
            pos = torch.full((B, 1), pos_t, device=x.device)
            if cfg.pos_embed == "rope":
                q = L.positions_for(cfg, q, pos)
                k = L.positions_for(cfg, k, pos)
            if window > 0:
                slot = pos_t % cache["k"].shape[1]
                write_row(cache["k"], slot, k[:, 0])
                write_row(cache["v"], slot, v[:, 0])
                write_row(cache["pos"], slot, pos_t)
            else:
                write_row(cache["k"], pos_t, k[:, 0])
                write_row(cache["v"], pos_t, v[:, 0])
    with span("repro.attn.core"):
        T = cache["k"].shape[1]
        if cross:
            o = _decode_per_shard(q, _expand_kv(cfg, cache["k"]), _expand_kv(cfg, cache["v"]),
                                  torch.ones(T, dtype=torch.bool, device=x.device), scale)
        elif window > 0:
            pos_c = cache["pos"]
            mask = (pos_c >= 0) & (pos_c <= pos_t) & (pos_c > pos_t - window)
            # the ring is whole along its slots
            o = _decode_per_shard(q, _expand_kv(cfg, cache["k"]), _expand_kv(cfg, cache["v"]),
                                  mask, scale)
        else:
            mask = torch.arange(T, device=x.device)[None] <= pos_t
            o = _decode(cfg, q, cache["k"], cache["v"], mask, scale)
    with span("repro.attn.out"):
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    return L.residual(x, out), cache


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


def _mla_latents(h, wq_a, q_norm, wkv_a, kv_norm, *, cfg: ModelConfig, start: int):
    """The down projections of h (B, S, d), the rows at positions start ..
    start + S - 1: the normed query latent (B, S, q_lora), the normed kv
    latent (B, S, kv_lora) and the rotated shared rope key (B, S, rope)."""
    cdt = L.compute_dtype(cfg)
    kl = cfg.mla_kv_lora
    positions = torch.arange(start, start + h.shape[1], device=h.device)[None]
    cq = _rms_latent(torch.matmul(h, wq_a.to(cdt)), q_norm)
    ckv_f = torch.matmul(h, wkv_a.to(cdt))
    c_kv = _rms_latent(ckv_f[..., :kl], kv_norm)
    k_rope = L.apply_rope(cfg, ckv_f[:, :, None, kl:], positions)[:, :, 0]
    return cq, c_kv, k_rope


def _mla_common(cfg: ModelConfig, p, x, h, start: int = 0):
    """(q_nope, q_rope, c_kv, k_rope) of the norm's output h, the rows at
    positions start .. start + S - 1.  Under the dry run's rules, with
    the sequence sharded (train, prefill), the down projections read each
    rank's own rows of h (the residual x's layout) and the narrow latents
    are gathered along the sequence; the cache keeps them sharded."""
    cdt = L.compute_dtype(cfg)
    dn = cfg.mla_nope_dim
    ws = [p[m] for m in ("wq_a", "q_norm", "wkv_a", "kv_norm")]
    axis, n = _seq_axis(x)
    if axis is not None and h.shape[1] % n == 0:
        descs = mla_descs(cfg)
        r = active_rules(x)
        fn = functools.partial(_mla_latents, cfg=cfg, start=_rows_start(r, h, ROWS_D))
        cq, c_kv, k_rope = per_shard(
            fn, [ROWS_D] + [descs[m].axes for m in ("wq_a", "q_norm", "wkv_a", "kv_norm")],
            [ROWS_D] * 3, constrain(h, ROWS_D), *ws)
        whole = ("batch", None, None)
        cq, c_kv_all, k_rope_all = (constrain(t, whole) for t in (cq, c_kv, k_rope))
    else:
        cq, c_kv, k_rope = _mla_latents(h, *ws, cfg=cfg, start=start)
        c_kv_all, k_rope_all = c_kv, k_rope
    positions = torch.arange(start, start + h.shape[1], device=h.device)[None]
    qf = torch.einsum("bsl,lhk->bshk", cq, p["wq_b"].to(cdt))
    q_nope, q_rope = qf[..., :dn], L.apply_rope(cfg, qf[..., dn:], positions)
    q_nope = constrain(q_nope, ("batch", None, "heads", None))
    return q_nope, q_rope, c_kv_all, k_rope_all, (c_kv, k_rope)


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

    if mode in ("train", "prefill"):
        h = L.apply_norm(cfg, p["norm"], x, axes=ROWS_D)
        q_nope, q_rope, c_kv, k_rope, latents = _mla_common(cfg, p, x, h)
        k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["wk_b"].to(cdt))
        v = torch.einsum("bsl,lhk->bshk", c_kv, p["wv_b"].to(cdt))
        k_nope = constrain(k_nope, ("batch", None, "heads", None))
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, cfg.n_heads, dr)], dim=-1)
        o = per_shard(functools.partial(causal_attention, scale=scale,
                                        kv_block=cfg.attn_kv_block),
                      [HEADS] * 3, [HEADS], q, k, v)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
        new_cache = dict(zip(("c_kv", "k_rope"), latents)) if mode == "prefill" else None
        return L.residual(x, out), new_cache

    # ---- absorbed decode: S == 1 ----
    if cache is None:
        raise ValueError("decode needs a cache")
    h = L.apply_norm(cfg, p["norm"], x)
    q_nope, q_rope, c_kv_new, k_rope_new, _ = _mla_common(cfg, p, x, h, start=pos_t)
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
    return L.residual(x, out), cache


def _mla_slice(q_eff, q_rope, ckv, krp, mask, *, scale, group, n):
    """The absorbed decode's attention on one rank's slice of the latent
    cache (B, Tl, L) and (B, Tl, R), merged with the other slices: the
    weighted latent (B, 1, H, L) in f32."""
    s = (torch.einsum("bshl,btl->bhst", q_eff.float(), ckv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), krp.float())) * scale
    m, l, p = _partial_softmax(s, mask[None])
    o = torch.einsum("bhst,btl->bhsl", p.to(ckv.dtype).float(), ckv.float())
    return _merge_partials(m, l, o, group, n).transpose(1, 2)
