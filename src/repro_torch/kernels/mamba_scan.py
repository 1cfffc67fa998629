"""Mamba-1 selective scan: the wrapper around the hand-written CUDA kernel.

Counterpart of the JAX package's Pallas kernel
(`repro/kernels/mamba_scan.py::mamba_scan`).  The kernel is
`csrc/mamba_scan.cu`; its header says what bounds it on the card and how it
is laid out.  A CPU tensor goes to the plain version
(`ref.ref_selective_scan`); a CUDA tensor goes to the kernel, or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_selective_scan

N_STATES = (8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry_point():
    """`mamba_scan_fwd` of the built library, with its argtypes set."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = build.library("mamba_scan").mamba_scan_fwd
    fn.argtypes = ([vp] * 8                       # u, dt, A, Bm, Cm, h0, y, h_fin
                   + [i] * 5                      # dtype, B, S, D, N
                   + [ll] * 8                     # (batch, seq) strides of u, dt, Bm, Cm
                   + [vp])                        # stream
    fn.restype = ctypes.c_int
    return fn


def mamba_scan(u, dt, A, Bm, Cm, h0=None):
    """u, dt: (B, S, D); A: (D, N) f32; Bm, Cm: (B, S, N); h0: (B, D, N) f32
    or None (zeros) -> (y: (B, S, D) in u's dtype, h_final: (B, D, N) f32).

    The CUDA kernel splits each channel's states across a group of lanes and
    masks the ragged edges, so any S and D work.  u, dt, Bm and Cm may be
    strided views with a contiguous last dim (on the main path Bm and Cm are
    slices of one projection); they are read through their strides, never
    copied.
    `mamba_scan.launches` counts the kernel's launches.
    """
    if u.dim() != 3 or dt.shape != u.shape or A.dim() != 2 or A.shape[0] != u.shape[2]:
        raise ValueError(f"want u = dt (B,S,D) and A (D,N); got {tuple(u.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    B, S, D = u.shape
    N = A.shape[1]
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N) or \
            (h0 is not None and h0.shape != (B, D, N)):
        raise ValueError(f"want Bm = Cm (B,S,N) = {(B, S, N)} and h0 (B,D,N); got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}, "
                         f"{None if h0 is None else tuple(h0.shape)}")
    tensors = [t for t in (u, dt, A, Bm, Cm, h0) if t is not None]
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        y, h_fin = ref_selective_scan(u, dt, A, Bm, Cm, h0)
        return y.to(u.dtype), h_fin
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"the inputs must all be on one CUDA device or all on "
                         f"the CPU; got {[str(t.device) for t in tensors]}")
    if u.dtype not in _DTYPE_CODES or any(t.dtype != u.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"the kernel takes float32 or bfloat16 u, dt, Bm, Cm of one "
                        f"dtype; got {u.dtype}, {dt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if A.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"A and h0 must be float32; got {A.dtype}, "
                        f"{None if h0 is None else h0.dtype}")
    if N not in N_STATES:
        raise ValueError(f"the kernel takes d_state in {N_STATES}; got {N}")
    if B * S * D == 0:
        raise ValueError(f"empty scan: u {tuple(u.shape)}")
    for name, t in (("u", u), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(2) != 1:
            raise ValueError(f"{name}: the kernel needs a contiguous last dim; "
                             f"got strides {t.stride()}")
    for name, t in (("A", A), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; got strides {t.stride()}")

    y = torch.empty((B, S, D), dtype=u.dtype, device=u.device)
    h_fin = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    fn = _entry_point()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
                 _DTYPE_CODES[u.dtype], B, S, D, N,
                 *u.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2],
                 stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    mamba_scan.launches += 1
    return y, h_fin


mamba_scan.launches = 0
