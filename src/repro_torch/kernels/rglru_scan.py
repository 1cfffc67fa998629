"""RG-LRU linear recurrence: the wrapper around the hand-written CUDA kernel.

Counterpart of the JAX package's Pallas kernel
(`repro/kernels/rglru_scan.py::rglru_scan`).  The kernel is
`csrc/rglru_scan.cu`; its header says what bounds it on the card and how it
is laid out.  A CPU tensor goes to the plain version
(`ref.ref_linear_scan`); a CUDA tensor goes to the kernel, or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_linear_scan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry_point():
    """`rglru_scan_fwd` of the built library, with its argtypes set."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = build.library("rglru_scan").rglru_scan_fwd
    fn.argtypes = ([vp] * 5                       # a, b, h0, hs, h_fin
                   + [i] * 4                      # dtype, B, S, W
                   + [ll] * 4                     # (batch, seq) strides of a, b
                   + [vp])                        # stream
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a, b, h0):
    """a, b: (B, S, W); h0: (B, W) f32 -> (hs: (B, S, W) in a's dtype,
    h_final: (B, W) f32), h_t = a_t * h_{t-1} + b_t with an f32 state.

    The CUDA kernel runs one thread per channel and masks the ragged edges,
    so any S and W work.  a and b may be strided views with a
    contiguous last dim.  `rglru_scan.launches` counts the kernel's launches.
    """
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"want a = b (B,S,W) and h0 (B,W); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    B, S, W = a.shape
    tensors = (a, b, h0)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        hs, h_fin = ref_linear_scan(a, b, h0)
        return hs.to(a.dtype), h_fin
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"a, b, h0 must all be on one CUDA device or all on "
                         f"the CPU; got {[str(t.device) for t in tensors]}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 a and b of one "
                        f"dtype; got {a.dtype}, {b.dtype}")
    if h0.dtype != torch.float32 or not h0.is_contiguous():
        raise TypeError(f"h0 must be contiguous float32; got {h0.dtype}, "
                        f"strides {h0.stride()}")
    if B * S * W == 0:
        raise ValueError(f"empty scan: a {tuple(a.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.stride(2) != 1:
            raise ValueError(f"{name}: the kernel needs a contiguous last dim; "
                             f"got strides {t.stride()}")

    hs = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    h_fin = torch.empty((B, W), dtype=torch.float32, device=a.device)
    fn = _entry_point()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(), h_fin.data_ptr(),
                 _DTYPE_CODES[a.dtype], B, S, W, *a.stride()[:2], *b.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return hs, h_fin


rglru_scan.launches = 0
