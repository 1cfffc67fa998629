"""The public kernel API.

Two tiers of entry point live here, as in the JAX package's
`repro/kernels/ops.py`:

  * the kernel wrappers themselves (one object, one launch counter):
    `flash_attention`, `mamba_scan` and `rglru_scan`;
  * per-example *task bodies* (`matmul_task`, `attention_task`) — plain
    torch functions over a single example, the granularity the
    device-batched executor fuses (`repro_torch.core.devicepool`,
    DESIGN.md §11).  Submitted alone they pay op-by-op dispatch (the
    overhead the paper's clustering amortizes, §3.13); submitted with a
    ``vmap_key`` the pool stacks K of them into one `torch.func.vmap`
    call.  They reach no kernel wrapper, as the reference's reach no
    Pallas kernel: `attention_task` computes with the plain oracle.  Their
    operation count is what `repro_torch.launch.op_cost.DurationPredictor`
    prices scheduling with.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.ref import ref_attention
from repro_torch.kernels.rglru_scan import rglru_scan

__all__ = ["flash_attention", "mamba_scan", "rglru_scan", "matmul_task",
           "attention_task"]


# -- per-example task bodies (device-batched executor granularity) ----------

def matmul_task(x, w):
    """One example's projection + nonlinearity: ``tanh(x @ w)`` row-summed.

    Shapes: ``x (d,)``, ``w (d, d)`` -> ``(d,)``.  Pure and vmappable; the
    weight is typically identical across a bundle, so the pool broadcasts
    it (``in_dims=None``) instead of stacking K copies.
    """
    return torch.sum(torch.tanh(x @ w), dim=-1) + x


def attention_task(q, k, v):
    """One example's attention, via the plain oracle's math.

    Shapes: ``q/k/v (heads, seq, dim)`` for a single example; the pool
    stacks bundles into the batched ``(K, heads, seq, dim)`` layout
    `ref_attention` already handles.
    """
    return ref_attention(q[None], k[None], v[None])[0]
