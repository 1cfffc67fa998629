"""Mamba-1 selective state update of one decode step: the wrapper around the
hand-written CUDA kernel, and its plain version.

The kernel is `csrc/mamba_step.cu`; it replaces no TPU kernel (the JAX
package's decode is one plain step) and its header says why it was added,
what bounds it on the card and how it is laid out.  A CPU tensor goes to
the plain version (`plain_state_step`); a CUDA tensor goes to the kernel,
or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

N_STATES = (8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def plain_state_step(h, x, dt, A_log, Bm, Cm):
    """h (B, D, N) f32, updated in place; x, dt (B, D); A_log (D, N); Bm, Cm
    (B, N) -> y (B, D) f32.  A = -exp(A_log), h <- exp(dt A) h + dt x B,
    y = h . C, all in f32: the decode step of the JAX package's
    `apply_mamba`, one eager pass per intermediate."""
    A = -torch.exp(A_log.float())
    dtf = dt.float()
    dA = torch.exp(dtf[..., None] * A[None])                       # (B, D, N)
    dBu = (dtf * x.float())[..., None] * Bm.float()[:, None, :]
    h_new = dA * h + dBu
    h.copy_(h_new)
    return torch.einsum("bdn,bn->bd", h_new, Cm.float())


def check_kernel_inputs(h, x, dt, A_log, Bm, Cm):
    """Raise unless the kernel takes these tensors (of agreeing shapes):
    x, dt, Bm, Cm of one dtype, f32 or bf16 (any strides); h and A_log f32,
    contiguous and 16-byte aligned (read a float4 at a time); a d_state it
    is built for; nothing empty."""
    B, D, N = h.shape
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"the kernel takes float32 or bfloat16 x, dt, Bm, Cm of one "
                        f"dtype; got {x.dtype}, {dt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if h.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise TypeError(f"h and A_log must be float32; got {h.dtype}, {A_log.dtype}")
    if N not in N_STATES:
        raise ValueError(f"the kernel takes d_state in {N_STATES}; got {N}")
    if B * D == 0:
        raise ValueError(f"empty state: h {tuple(h.shape)}")
    for name, t in (("h", h), ("A_log", A_log)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned; got strides "
                             f"{t.stride()}, address {t.data_ptr():#x}")


@functools.cache
def _entry_point():
    """`mamba_step_fwd` of the built library, with its argtypes set."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = build.library("mamba_step").mamba_step_fwd
    fn.argtypes = ([vp] * 7                       # h, x, dt, A_log, Bm, Cm, y
                   + [i] * 4                      # dtype, B, D, N
                   + [ll] * 8                     # strides of x, dt, Bm, Cm
                   + [vp])                        # stream
    fn.restype = ctypes.c_int
    return fn


def mamba_state_step(h, x, dt, A_log, Bm, Cm):
    """h (B, D, N) f32, contiguous, updated in place; x, dt (B, D); A_log
    (D, N) f32; Bm, Cm (B, N) -> y (B, D) in x's dtype.

    x, dt, Bm and Cm may be strided views (on the main path x is a
    batch-minor view of the conv step's output, Bm and Cm slices of one
    projection); they are read through their strides, never copied.  On
    the CPU, `plain_state_step` with its y cast to x's dtype.
    `mamba_state_step.launches` counts the kernel's launches.
    """
    if h.dim() != 3 or x.dim() != 2 or x.shape != h.shape[:2] or dt.shape != x.shape:
        raise ValueError(f"want h (B,D,N) and x = dt (B,D); got {tuple(h.shape)}, "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    B, D, N = h.shape
    if A_log.shape != (D, N) or Bm.shape != (B, N) or Cm.shape != (B, N):
        raise ValueError(f"want A_log (D,N) = {(D, N)} and Bm = Cm (B,N) = {(B, N)}; got "
                         f"{tuple(A_log.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    tensors = (h, x, dt, A_log, Bm, Cm)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return plain_state_step(h, x, dt, A_log, Bm, Cm).to(x.dtype)
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"the inputs must all be on one CUDA device or all on "
                         f"the CPU; got {[str(t.device) for t in tensors]}")
    check_kernel_inputs(h, x, dt, A_log, Bm, Cm)

    y = torch.empty((B, D), dtype=x.dtype, device=x.device)
    fn = _entry_point()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype], B, D, N,
                 *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(), stream)
    if err != 0:
        raise RuntimeError(f"mamba_state_step kernel launch failed: CUDA error {err}")
    mamba_state_step.launches += 1
    return y


mamba_state_step.launches = 0
