"""Mamba-1 selective-state-space block (falcon-mamba-7b).

Plain PyTorch version of the JAX package's `repro/models/ssm.py`.  The
selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t is evaluated as a
chunked linear recurrence, as there: a loop over time chunks carrying the
state, with the reference's work-efficient associative scan inside each
chunk (the odd/even recursion of `jax.lax.associative_scan`, `linear_scan`),
so that the (chunk, D, N) intermediates are the only expanded tensors.  With
`cfg.use_pallas`, prefill goes through the hand-written kernel
(`repro_torch.kernels.ops.mamba_scan`) instead, and decode's state update
through `repro_torch.kernels.ops.mamba_state_step` (the reference's decode
is one plain step, `kernels.mamba_step.plain_state_step` here).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import active_rules, constrain, partial_grad, per_shard
from repro_torch.kernels.mamba_step import plain_state_step
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDesc
from repro_torch.models.spans import span


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def mamba_descs(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    din = s.expand * d
    dtr = dt_rank(cfg)
    N, K = s.d_state, s.d_conv
    return {
        "norm": L.norm_descs(cfg),
        "in_proj": ParamDesc((d, 2 * din), ("embed", "inner")),
        "conv_w": ParamDesc((K, din), (None, "inner")),
        "conv_b": ParamDesc((din,), ("inner",), init="zeros"),
        "x_proj": ParamDesc((din, dtr + 2 * N), ("inner", None)),
        "dt_proj": ParamDesc((dtr, din), (None, "inner")),
        "dt_bias": ParamDesc((din,), ("inner",), init="zeros"),
        "A_log": ParamDesc((din, N), ("inner", "state"), init="ones", f32=True),
        "D": ParamDesc((din,), ("inner",), init="ones"),
        "out_proj": ParamDesc((din, d), ("inner", "embed")),
    }


def mamba_cache_descs(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return {
        "state": ParamDesc((batch, din, s.d_state), ("batch", "inner", None),
                           dtype=torch.float32),
        "conv": ParamDesc((batch, s.d_conv - 1, din), ("batch", None, "inner"),
                          dtype=L.compute_dtype(cfg)),
    }


def causal_conv(x, w, b):
    """x: (B, S, D); w: (K, D) depthwise causal conv -> (out, tail), where
    tail (B, K-1, D) is the last K-1 inputs (the decode cache), a copy, so
    that the cache does not hold the padded input alive."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i][None, None]
    return out + b[None, None], xp[:, S:].clone()


def conv_step(tail, x, w, b):
    """One decode step of `causal_conv`: tail (B, K-1, D), x (B, 1, D) ->
    (out (B, D), the K inputs the step saw)."""
    window = torch.cat([tail.to(x.dtype), x], dim=1)               # (B, K, D)
    return torch.einsum("bkd,kd->bd", window, w) + b, window


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over dim 1 from h = 0, by
    the reference's recursion (`jax.lax.associative_scan` with its
    `combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)`), the same f32
    operations in the same order: combine adjacent pairs, scan the half
    (the odd elements' results), combine each odd result with the next
    even element, and interleave.  log2(n) levels of ~n / 2^level combines
    each; each level writes its result into one new tensor per output.

    Returns (prod of a up to t, h_t)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_ev, b_ev, a_od, b_od = a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2]
    ra, rb = linear_scan(a_ev * a_od, a_od * b_ev + b_od)         # the odd elements
    pa, pb = (ra[:, :-1], rb[:, :-1]) if n % 2 == 0 else (ra, rb)
    xa, xb = a[:, 2::2], b[:, 2::2]
    outs = []
    for x, odd, even in ((a, ra, pa * xa), (b, rb, xa * pb + xb)):
        out = x.new_empty(x.shape)
        out[:, :1] = x[:, :1]
        out[:, 2::2] = even
        out[:, 1::2] = odd
        outs.append(out)
    return outs[0], outs[1]


def n_chunks(S: int, chunk: int) -> int:
    """The JAX package's chunk count: the largest count <= S // chunk that
    divides S."""
    nc = max(1, S // chunk)
    while S % nc:
        nc -= 1
    return nc


def selective_scan(u, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """u, dt: (B, S, D); A: (D, N); Bm, Cm: (B, S, N) -> (y f32, h_final f32).

    y_t = C_t . h_t,  h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t
    """
    B, S, D = u.shape
    N = A.shape[1]
    ch = S // n_chunks(S, chunk)
    h = torch.zeros((B, D, N), device=u.device) if h0 is None else h0
    ys = []
    for c0 in range(0, S, ch):
        sl = slice(c0, c0 + ch)
        dt_ = dt[:, sl].float()
        dA = torch.exp(dt_[..., None] * A[None, None])                     # (B,ch,D,N)
        dBu = (dt_ * u[:, sl].float())[..., None] * Bm[:, sl].float()[..., None, :]
        accA, accB = linear_scan(dA, dBu)
        hs = accA * h[:, None] + accB                                      # (B,ch,D,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, sl].float()))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _gates(cfg: ModelConfig, p, xc):
    """The scan's inputs from the conv output: (dt, Bm, Cm).  Bm and Cm are
    slices of one projection (strided views)."""
    cdt = L.compute_dtype(cfg)
    dtr, N = dt_rank(cfg), cfg.ssm.d_state
    proj = torch.einsum("bsd,de->bse", xc, p["x_proj"].to(cdt))
    # the product sums over the sharded width: reduce it before it is cut
    # (a no-op outside the dry run)
    proj = constrain(proj, ("batch", None, None))
    # the scan passes its gradients of Bm and Cm back whole, dt_proj's
    # product that of dt_r as a partial sum: summed as one
    bc = partial_grad(proj, "inner")
    dt_r, Bm, Cm = proj[..., :dtr], bc[..., dtr:dtr + N], bc[..., dtr + N:]
    dt = F.softplus(torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"].to(cdt))
                    + p["dt_bias"].to(cdt))
    return dt, Bm, Cm


def _in_proj(w, h, din: int, mode: str):
    """(xin, z), the two halves of h's projection by `in_proj` (d, 2 din).

    Under the dry run's rules `in_proj` is sharded across its whole width,
    so a rank's columns lie in one half: slicing the product would gather
    it whole.  In train and prefill the weight is gathered once instead
    (d x 2 din, against the product's tokens x 2 din) and each half is
    formed from its own columns, sharded over "inner"; in decode, one token
    a row, the product is the smaller and is sliced.  Elsewhere one
    product, sliced."""
    inner = ("batch", None, "inner")
    if mode == "decode" or active_rules(h) is None:
        xz = constrain(torch.einsum("bsd,de->bse", h, w), inner)
        return tuple(constrain(t, inner) for t in (xz[..., :din], xz[..., din:]))
    w = constrain(w, ("embed", None))
    return tuple(constrain(torch.einsum("bsd,de->bse", h, constrain(half, ("embed", "inner"))),
                           inner) for half in (w[:, :din], w[:, din:]))


def apply_mamba(cfg: ModelConfig, p, x, *, mode="prefill", cache=None, pos_t=None):
    """Returns (out, new_cache).

    Train mode is prefill without a cache (`new_cache` is None), through the
    plain chunked scan under autograd.  Decode writes the new state and conv
    tail into `cache` in place (the JAX package returns an updated copy) and
    returns the same dict.
    """
    s = cfg.ssm
    cdt = L.compute_dtype(cfg)
    din = s.expand * x.shape[2]
    with span("repro.mamba.in_proj"):
        h = L.apply_norm(cfg, p["norm"], x)
        xin, z = _in_proj(p["in_proj"].to(cdt), h, din, mode)

    if mode in ("train", "prefill"):
        if mode == "train" and cfg.use_pallas:
            raise NotImplementedError(L.FORWARD_ONLY.format(kernel="the selective scan"))
        with span("repro.mamba.conv"):
            xc, tail = causal_conv(xin, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
            xc = F.silu(xc)
        with span("repro.mamba.gates"):
            dt, Bm, Cm = _gates(cfg, p, xc)
        with span("repro.mamba.scan"):
            A = -torch.exp(p["A_log"].float())
            if cfg.use_pallas:
                from repro_torch.kernels import ops as kops
                y, h_fin = kops.mamba_scan(xc, dt, A, Bm, Cm)
            else:
                # local in batch and width: under the dry run's rules each
                # rank scans its own shards
                y, h_fin = per_shard(
                    functools.partial(selective_scan, chunk=s.chunk),
                    [("batch", None, "inner")] * 2 + [("inner", None)]
                    + [("batch", None, None)] * 2,
                    [("batch", None, "inner"), ("batch", "inner", None)],
                    xc, dt, A, Bm, Cm)
        with span("repro.mamba.out"):
            y = y.to(cdt) + xc * p["D"].to(cdt)
            out = torch.einsum("bsd,de->bse", y * F.silu(z), p["out_proj"].to(cdt))
            out = L.residual(x, out)
        return out, (None if mode == "train" else {"state": h_fin, "conv": tail})

    if cache is None:
        raise ValueError("decode needs a cache")
    # each cache is written as soon as its new value exists: nothing after
    # reads the cache or writes what its new value was made from
    with span("repro.mamba.conv"):
        xc, window = conv_step(cache["conv"], xin, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
        xc = F.silu(xc)[:, None]                                       # (B, 1, din)
        cache["conv"].copy_(window[:, 1:])
    with span("repro.mamba.gates"):
        dt, Bm, Cm = _gates(cfg, p, xc)
    with span("repro.mamba.state"):
        # the new state is written into the cache in place
        step = (cache["state"], xc[:, 0], dt[:, 0], p["A_log"].float(), Bm[:, 0], Cm[:, 0])
        if cfg.use_pallas:
            from repro_torch.kernels import ops as kops
            y = kops.mamba_state_step(*step)
        else:
            y = plain_state_step(*step)
    with span("repro.mamba.out"):
        y = y[:, None].to(cdt) + xc * p["D"].to(cdt)
        out = torch.einsum("bsd,de->bse", y * F.silu(z), p["out_proj"].to(cdt))
        return L.residual(x, out), cache
