"""Gradient compression for cross-pod sync.

The port of the JAX package's `repro/optim/compression.py`, on trees of
tensors (leaves in `tree_leaves` order).  Two standard schemes with error
feedback (residual carry), usable when the trainer runs in explicit-sync
mode (a cross-pod gradient exchange over the slowest link):

  * int8 quantization: per-tensor scale, symmetric; `torch.round` rounds
    half to even, as `jnp.round` does
  * top-k sparsification: keep the k largest-|g| entries, indices int32 as
    `jax.lax.top_k` returns them (sorted by |g|, descending)

Plain tensor ops: the reference has no kernel here.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_leaves, tree_map


def quantize_int8(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def topk_sparsify(g, frac: float):
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx.to(torch.int32), flat.numel()


def topk_densify(vals, idx, size, shape):
    out = vals.new_zeros(size)
    out[idx.long()] = vals
    return out.reshape(shape)


def compress_with_feedback(grads, residual, scheme: str = "int8",
                           topk_frac: float = 0.01):
    """Returns (compressed_repr, new_residual, decompressed).

    compressed_repr is a list with one (q, scale) or (vals, idx) pair per
    leaf; decompressed is what the receiver reconstructs; residual carries
    the compression error into the next step (error feedback).
    """
    if scheme not in ("int8", "topk"):
        raise ValueError(f"unknown scheme {scheme!r}")

    def one(g, r):
        x = g + r
        if scheme == "int8":
            q, scale = quantize_int8(x)
            deq = dequantize_int8(q, scale)
            return (q, scale), x - deq, deq
        vals, idx, size = topk_sparsify(x, topk_frac)
        deq = topk_densify(vals, idx, size, x.shape)
        return (vals, idx), x - deq, deq

    leaves = tree_leaves(grads)
    outs = {id(g): one(g, r) for g, r in zip(leaves, tree_leaves(residual))}
    comp = [outs[id(g)][0] for g in leaves]
    new_r = tree_map(lambda g: outs[id(g)][1], grads)
    deq = tree_map(lambda g: outs[id(g)][2], grads)
    return comp, new_r, deq


def init_residual(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compressed_bytes(comp) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(comp))
