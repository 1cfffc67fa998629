"""Plain PyTorch versions of the kernels: the CPU path and the ground truth.

`ref_linear_scan` and `ref_selective_scan` come with their kernels
(ROADMAP.md, Queue 2).
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
