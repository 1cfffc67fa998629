"""What the plain references share: f32 arithmetic with TF32 off, the
RMSNorm, the products (with the lower-precision control), and reading one
layer of a stacked layer group.  Plain PyTorch; imports nothing of the
port, of the JAX package or of JAX."""
from __future__ import annotations

import contextlib

import torch

FP8 = getattr(torch, "float8_e4m3fn", None)
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32, TF32 off (and restored after), without
    autograd."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8(x, dim: int):
    """x rounded to float8 e4m3 with one scale per slice along `dim`, the
    absolute maximum mapped to the format's largest value; back in f32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(FP8).float() * scale


def lin(x, w, control: bool = False):
    """x (..., K) @ w (K, N) in f32.  The control is the same product
    computed in the precision below the served bf16: float8 e4m3 operands,
    one scale per row of x and per output column of w (float8 serving's
    recipe), accumulated in f32."""
    x, w = x.float(), w.float()
    if not control:
        return x @ w
    return fp8(x, -1) @ fp8(w, 0)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def layer(group: dict, r: int) -> dict:
    """Layer r of a stacked layer group (every leaf's leading dim), in f32."""
    if isinstance(group, dict):
        return {k: layer(v, r) for k, v in group.items()}
    return group[r].float()
