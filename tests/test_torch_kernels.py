"""The port's attention kernel wrapper and plain version against the JAX
package's, on the same numpy inputs.

CPU tensors take the port's plain version; the JAX side runs its Pallas
kernel in interpret mode (as tests/test_kernels.py does) and its oracle.
The `cuda` cases run the hand-written kernel and skip without a card.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import check_kernel_inputs, flash_attention  # noqa: E402

SHAPES = [  # tests/test_kernels.py:21-28
    (1, 1, 1, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 1, 128, 32),      # MQA
    (2, 2, 2, 192, 64),      # odd block split
]
MASKS = [(True, 0), (True, 64), (False, 0)]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # tests/test_kernels.py:12-14: bf16 rounds p before the PV product
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernel API and oracles (imported here, so that the
    `cuda` cases of this file also run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops, ref
    return types.SimpleNamespace(jnp=jax.numpy, ops=ops, ref=ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    return torch.device("cuda")


def _inputs(B, Hq, Hkv, S, D, seed=0, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, Hq, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, T, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, T, D), dtype=np.float32))


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype)) for a in arrs]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("B,Hq,Hkv,S,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_attention_matches_reference(jref, B, Hq, Hkv, S, D, causal,
                                          window, dtype):
    arrs = _inputs(B, Hq, Hkv, S, D)
    jq, jk, jv = (jref.jnp.asarray(a).astype(dtype) for a in arrs)
    exp_kernel = jref.ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                          block_q=64, block_k=64)
    exp_ref = jref.ref.ref_attention(jq, jk, jv, causal=causal, window=window)
    q, k, v = _torch(arrs, dtype)
    flash_attention.launches = 0
    got_plain = tref.ref_attention(q, k, v, causal=causal, window=window)
    got_ops = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == 0  # CPU tensors never reach the kernel
    for got in (got_plain, got_ops):
        assert got.dtype == q.dtype and got.shape == q.shape
        for exp in (exp_kernel, exp_ref):
            np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32),
                                       **_tol(dtype))


@pytest.mark.parametrize("S,T,D", [(100, 100, 16), (37, 37, 32), (1000, 1000, 64),
                                   (40, 150, 32), (70, 70, 256)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_ragged_lengths_match_reference_oracle(jref, S, T, D, causal, window):
    arrs = _inputs(1, 4, 2, S, D, seed=S, T=T)
    exp = jref.ref.ref_attention(*(jref.jnp.asarray(a) for a in arrs),
                                 causal=causal, window=window)
    got = tops.flash_attention(*_torch(arrs, "float32"), causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(exp), **_tol("float32"))


def test_wrapper_rejects_bad_shapes_and_devices():
    q, k, v = _torch(_inputs(1, 3, 2, 16, 16), "float32")
    with pytest.raises(ValueError, match="Hq % Hkv"):
        tops.flash_attention(q, k, v)
    q, k, v = (t.to("meta") for t in _torch(_inputs(1, 2, 2, 16, 16), "float32"))
    with pytest.raises(ValueError, match="CUDA device"):
        tops.flash_attention(q, k, v)   # no fallback off the CPU


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_takes_head_dim_160(dtype):
    """stablelm-12b runs at head_dim 5120 / 32 = 160: the wrapper's checks
    pass for it on the main path's views, in both dtypes."""
    def mk(h):
        return torch.zeros((1, 40, h, 160), dtype=getattr(torch, dtype)).transpose(1, 2)
    q, k, v = mk(32), mk(8), mk(8)
    check_kernel_inputs(q, k, v, torch.empty_like(q))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_takes_head_dim_256(dtype):
    """recurrentgemma-9b's local layers run at head_dim 256: the checks the
    wrapper makes before a launch pass for it, in both dtypes, on the main
    path's (B, S, H, D) views; a head_dim the kernel is not built for is
    refused."""
    def mk(h, d):
        return torch.zeros((1, 40, h, d), dtype=getattr(torch, dtype)).transpose(1, 2)
    q, k, v = mk(16, 256), mk(1, 256), mk(1, 256)
    check_kernel_inputs(q, k, v, torch.empty_like(q))
    q, k, v = mk(16, 48), mk(1, 48), mk(1, 48)
    with pytest.raises(ValueError, match="head_dim"):
        check_kernel_inputs(q, k, v, torch.empty_like(q))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D", SHAPES + [(2, 4, 2, 100, 16), (1, 12, 2, 300, 128),
                                                 (2, 16, 1, 300, 256)])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(cuda, B, Hq, Hkv, S, D, causal, window, dtype):
    q, k, v = _torch(_inputs(B, Hq, Hkv, S, D), dtype, cuda)
    flash_attention.launches = 0
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    exp = tref.ref_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(40, 150), (150, 150), (70, 200)])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_ragged_and_longer_kv(cuda, S, T, causal, window, dtype):
    q, k, v = _torch(_inputs(2, 4, 2, S, 64, T=T), dtype, cuda)
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    exp = tref.ref_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views(cuda):
    """(B, S, H, D) projections seen as (B, H, S, D) go in without a copy,
    and give what the contiguous layout and the plain version give."""
    q, k, v = _torch(_inputs(2, 4, 2, 96, 64), "bfloat16", cuda)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    got = tops.flash_attention(qs, ks, vs, causal=True)
    exp = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_np(got), _np(exp))
    plain = tref.ref_attention(qs, ks, vs, causal=True)
    np.testing.assert_allclose(_np(got), _np(plain), **_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_head_dim_256_local_window(cuda, dtype):
    """recurrentgemma-9b's local layers: MQA (16 q heads, 1 kv head), head_dim
    256, window 2048, on the main path's strided views, past one window."""
    q, k, v = _torch(_inputs(1, 16, 1, 2100, 256), dtype, cuda)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    flash_attention.launches = 0
    got = tops.flash_attention(q, k, v, causal=True, window=2048)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    exp = tref.ref_attention(q, k, v, causal=True, window=2048)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


def test_library_name_carries_source_and_flags(tmp_path, monkeypatch):
    """A library is rebuilt when its source or the nvcc flags change."""
    from repro_torch.kernels import build
    same = build.library_path("mamba_scan")
    assert same.parent == build.BUILD_DIR and same.name.startswith("mamba_scan-")
    src = build.source("mamba_scan")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / src.name).write_bytes(src.read_bytes())
    assert build.library_path("mamba_scan") == same
    (tmp_path / src.name).write_bytes(src.read_bytes() + b"\n")
    assert build.library_path("mamba_scan") != same
    monkeypatch.setattr(build, "CSRC", src.parent)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("mamba_scan") != same


# ---------------------------------------------------------------------------
# the bf16 kernel's tiling on the card: ring prologue and epilogue, ragged
# edges, windows that start mid-tile, every head dim, the serving shape
# ---------------------------------------------------------------------------

def _check_cuda(cuda, B, Hq, Hkv, S, D, causal, window, dtype, T=None, strided=False):
    q, k, v = _torch(_inputs(B, Hq, Hkv, S, D, seed=S + D, T=T), dtype, cuda)
    if strided:   # the main path's (B, S, H, D) projections seen as (B, H, S, D)
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    flash_attention.launches = 0
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    exp = tref.ref_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D,S", [(64, 128), (64, 256), (64, 384),     # kv tiles of 128 rows
                                 (160, 64), (160, 128), (160, 192),   # of 64 rows from D 160 up
                                 (256, 64), (256, 128), (256, 192)])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_one_two_three_kv_tiles(cuda, D, S, causal, window, dtype):
    _check_cuda(cuda, 1, 4, 2, S, D, causal, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(129, 257), (300, 300), (77, 200), (250, 250)])
@pytest.mark.parametrize("D", [128, 160, 256])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_lengths_off_the_tiles(cuda, S, T, D, causal, window, dtype):
    _check_cuda(cuda, 2, 4, 2, S, D, causal, window, dtype, T=T)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [40, 100, 129])
@pytest.mark.parametrize("D", [64, 128, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_window_starts_mid_tile(cuda, window, D, causal, dtype):
    _check_cuda(cuda, 1, 4, 1, 333, D, causal, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128, 160, 256])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_every_head_dim(cuda, D, causal, window, dtype):
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert D in HEAD_DIMS
    _check_cuda(cuda, 2, 4, 2, 200, D, causal, window, dtype, strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_qwen2_serving_shape(cuda, dtype):
    """qwen2-1.5b's prefill: B 4, Hq 12, Hkv 2, S 2048, D 128, causal, on
    the strided views the main path hands the kernel."""
    _check_cuda(cuda, 4, 12, 2, 2048, 128, True, 0, dtype, strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_stablelm_serving_shape(cuda, causal, window, dtype):
    """stablelm-12b's prefill at head_dim 160: B 4, Hq 32, Hkv 8, S 2048,
    on the strided views the main path hands the kernel."""
    _check_cuda(cuda, 4, 32, 8, 2048, 160, causal, window, dtype, strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_whisper_encoder_shape(cuda, dtype):
    """whisper-large-v3's encoder: bidirectional at 1500 frames, a length
    off the tiles, B 4, 20 heads, head_dim 64."""
    _check_cuda(cuda, 4, 20, 20, 1500, 64, False, 0, dtype, strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_gemma3_local_shape(cuda, dtype):
    """gemma3-27b's local layers: window 1024 shorter than the 2048-token
    prompt, B 4, Hq 32, Hkv 16, head_dim 128."""
    _check_cuda(cuda, 4, 32, 16, 2048, 128, True, 1024, dtype, strided=True)
