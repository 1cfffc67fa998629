"""Plain PyTorch versions of the kernels: the CPU path and the ground truth.

Counterparts of the JAX package's oracles (`repro/kernels/ref.py`): the
scans run step by step over time in f32, as that package's `lax.scan`s do.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, T, D); GQA by head repetition.

    The mask is top-left aligned (col <= row, then col > row - window);
    masked scores are -1e30.  Scores and softmax are f32; the weights are
    cast to v's dtype before the PV product, which accumulates in f32.
    """
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.matmul(w.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def ref_linear_scan(a, b, h0):
    """RG-LRU-style recurrence h_t = a_t * h_{t-1} + b_t.

    a, b: (B, S, W); h0: (B, W).  Computed in f32; returns
    (hs: (B, S, W) f32, h_final: (B, W) f32)."""
    a, b, h = a.float(), b.float(), h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def ref_selective_scan(u, dt, A, Bm, Cm, h0=None):
    """Mamba-1 selective scan, h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t,
    y_t = h_t . C_t.

    u, dt: (B, S, D); A: (D, N); Bm, Cm: (B, S, N); h0: (B, D, N) or None
    (zeros).  Computed in f32; returns (y: (B, S, D) f32, h_final f32)."""
    B, S, D = u.shape
    N = A.shape[1]
    u, dt, A, Bm, Cm = (t.float() for t in (u, dt, A, Bm, Cm))
    h = torch.zeros((B, D, N), device=u.device) if h0 is None else h0.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A[None])                  # (B, D, N)
        dBu = (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]    # (B, D, N)
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h
