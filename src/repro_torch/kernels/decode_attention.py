"""Attention decode over a global KV cache: the wrapper around the
hand-written CUDA kernel, and its plain version.

The kernel is `csrc/decode_attention.cu`; it replaces no TPU kernel (the
JAX package's decode is one plain step) and its header says why it was
added, what bounds it on the card and how it is laid out.  A CPU tensor
goes to the plain version (`plain_decode_attention`); a CUDA tensor goes to
the kernel, or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS

MAX_GROUP = 16              # query heads a kv head: one mma tile of rows
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the split-T cut: enough (session, kv head, split) blocks for BLOCKS_PER_SM
# a streaming multiprocessor (two resident at head_dim 128, so ~4 waves),
# and no split shorter than MIN_SPLIT positions
BLOCKS_PER_SM = 8
MIN_SPLIT = 256


def plain_decode_attention(q, k, v, length, scale):
    """q (B, 1, Hq, D); k, v (B, T, Hkv, D) -> (B, 1, Hq, D): the model's
    `decode_attention` over the kv heads repeated to the query heads and
    the prefix mask of the first `length` positions."""
    from repro_torch.models.attention import _repeat_kv, decode_attention
    group = q.shape[2] // k.shape[2]
    mask = torch.arange(k.shape[1], device=q.device) < length
    return decode_attention(q, _repeat_kv(k, group), _repeat_kv(v, group), mask, scale)


def counting_inputs(k):
    """k, v of the counting check beside a case's k (B, T, Hkv, D): k zero,
    so every score is 0, and v one-hot along (t + b + h) mod D, as the
    second layer's views of stacked caches.  The output over the first
    `length` positions is then `counting_exact`'s; one position left out,
    counted twice or read past `length` moves some o[d] by 1 / (length / D)
    of it."""
    B, T, Hkv, D = k.shape
    ar = functools.partial(torch.arange, device=k.device)
    hot = (ar(T)[None, :, None] + ar(B)[:, None, None] + ar(Hkv)[None, None, :]) % D
    v = torch.zeros(2, B, T, Hkv, D, dtype=k.dtype, device=k.device)
    v[1].scatter_(3, hot[..., None], 1.0)
    return torch.zeros_like(k), v[1]


def counting_exact(B: int, Hq: int, G: int, D: int, length: int, device) -> torch.Tensor:
    """The counting check's output (B, 1, Hq, D) in float64: o[b, h, d] is
    the share of the positions t < length with (t + b + h // G) mod D = d."""
    ar = functools.partial(torch.arange, device=device)
    r = (ar(D)[None, None, :] - ar(B)[:, None, None] - ar(Hq)[None, :, None] // G) % D
    count = torch.where(r < length, (length - 1 - r) // D + 1, 0)
    return (count.double() / length)[:, None]


def split_count(B: int, Hkv: int, length: int, n_sm: int) -> tuple[int, int]:
    """(splits, chunk): the length cut into `splits` runs of `chunk`
    positions (the last one shorter), none empty."""
    want = -(-BLOCKS_PER_SM * n_sm // (B * Hkv))
    splits = max(1, min(want, -(-length // MIN_SPLIT)))
    chunk = -(-length // splits)
    return -(-length // chunk), chunk


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_kernel_inputs(q, k, v):
    """Raise unless the kernel takes these tensors (of agreeing shapes):
    one dtype, f32 or bf16; a head_dim it is built for; at most MAX_GROUP
    query heads a kv head; nothing empty; rows it can read with 16-byte
    loads."""
    B, _, Hq, D = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}; got {D}")
    if Hq // k.shape[2] > MAX_GROUP:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads a kv head; "
                         f"got {Hq} over {k.shape[2]}")
    if B * Hq == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(st % vec for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: the kernel reads rows with 16-byte loads; "
                             f"it needs a contiguous last dim, 16-byte aligned "
                             f"data and strides that are multiples of {vec}; "
                             f"got strides {t.stride()}")


@functools.cache
def _entry_point():
    """`decode_attention_fwd` of the built library, with its argtypes set."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = build.library("decode_attention").decode_attention_fwd
    fn.argtypes = ([vp] * 5 + [i]                 # q, k, v, o, partials, dtype
                   + [i] * 7                      # B, Hkv, G, D, length, chunk, splits
                   + [ll] * 8                     # strides of q (b, h), k and v (b, t, h)
                   + [ctypes.c_float, vp])        # scale, stream
    fn.restype = ctypes.c_int
    return fn


def decode_attention_kernel(q, k, v, length: int, scale: float):
    """q (B, 1, Hq, D); k, v (B, T, Hkv, D), query head h reading kv head
    h // (Hq / Hkv); length, a Python int in 1..T -> (B, 1, Hq, D) in q's
    dtype: attention over the first `length` positions of the cache.

    k and v may be strided views (on the main path the layer's views of
    the stacked caches); they are read through their strides, never copied,
    and never written.  On the CPU, `plain_decode_attention`.
    `decode_attention_kernel.launches` counts the kernel's launches: one a
    call, two where the length is cut into splits (the second merges them).
    """
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,1,Hq,D), k = v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         f"(batch, head_dim, or Hq % Hkv != 0)")
    if not isinstance(length, int) or isinstance(length, bool):
        raise TypeError(f"length must be a Python int; got {type(length).__name__}")
    if not 1 <= length <= T:
        raise ValueError(f"length must lie in 1..{T}; got {length}")
    tensors = (q, k, v)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return plain_decode_attention(q, k, v, length, scale)
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"q, k, v must all be on one CUDA device or all on "
                         f"the CPU; got {[str(t.device) for t in tensors]}")
    check_kernel_inputs(q, k, v)

    splits, chunk = split_count(B, Hkv, length, _sm_count(q.device.index))
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    part = (torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    fn = _entry_point()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), _DTYPE_CODES[q.dtype],
                 B, Hkv, Hq // Hkv, D, length, chunk, splits,
                 q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention_kernel.launches += 1 if splits == 1 else 2
    return out


decode_attention_kernel.launches = 0
