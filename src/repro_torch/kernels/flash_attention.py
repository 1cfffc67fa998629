"""Flash attention: the wrapper around the hand-written CUDA kernel.

Counterpart of the JAX package's Pallas kernel
(`repro/kernels/flash_attention.py::flash_attention`).  The kernel is
`csrc/flash_attention.cu`; its header says what bounds it on the card and
how it is laid out.  A CPU tensor goes to the plain version
(`ref.ref_attention`); a CUDA tensor goes to the kernel, or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_attention

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry_point():
    """`flash_attention_fwd` of the built library, with its argtypes set
    (`c_void_p` for every pointer and the stream, so none is cut to 32 bits)."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([vp, vp, vp, vp, i,          # q, k, v, o, dtype
                    i, i, i, i, i, i]            # B, Hq, Hkv, S, T, D
                   + [ll] * 12                   # (batch, head, seq) strides of q, k, v, o
                   + [ctypes.c_float, i, i, vp])  # scale, causal, window, stream
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, T, D) -> (B, Hq, S, D) in q's dtype.

    The CUDA kernel tiles the sequence and masks the ragged edge, so any S
    and T work: bf16 runs on the tensor cores with the softmax in
    registers, f32 on a scalar kernel (csrc/flash_attention.cu).  The
    inputs may be strided views (the last dim contiguous), e.g. (B, S, H, D)
    projections seen as (B, H, S, D).
    `flash_attention.launches` counts the kernel's launches.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Hq,S,D), k = v (B,Hkv,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         f"(batch, head_dim, or Hq % Hkv != 0)")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return ref_attention(q, k, v, causal=causal, window=window, scale=scale)
    if devices != {"cuda"} or len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"q, k, v must all be on one CUDA device or all on "
                         f"the CPU; got {[str(t.device) for t in (q, k, v)]}")
    out = torch.empty_like(q)
    check_kernel_inputs(q, k, v, out)
    fn = _entry_point()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[q.dtype], B, Hq, Hkv, S, T, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(scale), int(bool(causal)),
                 int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def check_kernel_inputs(q, k, v, out):
    """Raise unless the kernel takes these tensors (of agreeing shapes):
    one dtype, f32 or bf16; a head_dim it is built for; nothing empty; rows
    it can read with 16-byte loads."""
    B, Hq, S, D = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}; got {D}")
    if S == 0 or k.shape[2] == 0 or B * Hq == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if (t.stride(3) != 1 or any(st % vec for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: the kernel reads rows with 16-byte loads; "
                             f"it needs a contiguous last dim, 16-byte aligned "
                             f"data and strides that are multiples of {vec}; "
                             f"got strides {t.stride()}")
