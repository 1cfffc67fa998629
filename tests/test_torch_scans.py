"""The port's two scan kernel wrappers (Mamba selective scan, RG-LRU linear
recurrence) and their plain versions against the JAX package's, on the same
numpy inputs.

CPU tensors take the port's plain versions; the JAX side runs its Pallas
kernels in interpret mode (as tests/test_kernels.py does) and its oracles.
Shapes and tolerances are those of tests/test_kernels.py: rglru f32 2e-5,
bf16 2e-2; mamba f32 5e-5, bf16 5e-2 (bf16 y is rounded once more); the
state carried across a split 1e-5.  The `cuda` cases run the hand-written
kernels against the plain versions on the card and skip without one.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

RGLRU_SHAPES = [(1, 64, 128), (2, 128, 256), (2, 96, 128)]      # tests/test_kernels.py:66-70
RGLRU_TILES = [(16, 128), (32, 128), (32, 64)]
MAMBA_SHAPES = [(1, 32, 64, 8), (2, 64, 128, 16), (1, 96, 64, 8)]  # tests/test_kernels.py:105-109
MAMBA_TILES = [(8, 64), (16, 64), (32, 32)]
DTYPES = ["float32", "bfloat16"]


def _rglru_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _mamba_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernel API and oracles (imported here, so that the
    `cuda` cases of this file also run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops, ref
    return types.SimpleNamespace(jnp=jax.numpy, lax=jax.lax, ops=ops, ref=ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels run only on the card")
    return torch.device("cuda")


def _rglru_inputs(B, S, W, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32),
            rng.standard_normal((B, S, W), dtype=np.float32),
            rng.standard_normal((B, W), dtype=np.float32))


def _mamba_inputs(B, S, D, N, seed=2):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, D), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D), dtype=np.float32)))  # softplus
    A = -np.exp(rng.standard_normal((D, N), dtype=np.float32) * 0.5)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return u, dt, A, Bm, Cm


def _t(a, dtype="float32", device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(t):
    return t.float().cpu().numpy()


# ---------------------------------------------------------------------------
# the chunks' associative scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 16, 83, 127, 128, 256])
@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_linear_scan_is_the_reference_associative_scan(jref, n, kind):
    """`linear_scan` runs `jax.lax.associative_scan`'s recursion with the
    reference's `combine` (src/repro/models/ssm.py:86-91, rglru.py:74-79):
    the same f32 operations in the same order, so the same bits, odd
    lengths included.  XLA's CPU flushes subnormals to zero (a product of
    256 factors in [0.5, 1) reaches them), so the port runs here with
    torch's flush on as well."""
    shape = (2, n, 6, 4) if kind == "mamba" else (2, n, 10)     # (B, n, D, N), (B, n, W)
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape, dtype=np.float32)

    def combine(p, q):
        a1, b1 = p
        a2, b2 = q
        return a1 * a2, a2 * b1 + b2

    exp_a, exp_b = jref.lax.associative_scan(combine, (jref.jnp.asarray(a), jref.jnp.asarray(b)),
                                             axis=1)
    assert torch.set_flush_denormal(True)
    try:
        got_a, got_b = TS.linear_scan(_t(a), _t(b))
    finally:
        torch.set_flush_denormal(False)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(exp_a))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(exp_b))


def _saved_bytes(fn):
    """Bytes of the storages autograd saves while fn() runs, each once."""
    saved = {}

    def pack(t):
        s = t.untyped_storage()
        saved[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(saved.values())


@pytest.mark.parametrize("scan,limit", [("selective_scan", 8.5), ("rglru_scan", 14.5)])
def test_chunked_scan_saves_few_whole_sequences(scan, limit):
    """What autograd keeps of the plain chunked scans, in whole-sequence
    f32 tensors ((B, S, D, N) for Mamba, (B, S, W) for RG-LRU), at the
    models' chunks (128, 256): the recursion saves each level's operands,
    ~2 sequences of a and of b over all levels, where a Hillis-Steele scan
    kept every one of its log2(chunk) levels (16 and 24 units)."""
    rng = np.random.default_rng(8)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).requires_grad_()

    if scan == "selective_scan":
        B, S, D, N = 2, 512, 64, 16
        args = (leaf(B, S, D), leaf(B, S, D), leaf(D, N), leaf(B, S, N), leaf(B, S, N))
        units = _saved_bytes(lambda: TS.selective_scan(*args, chunk=128)) / (B * S * D * N * 4)
    else:
        B, S, W = 2, 512, 128
        args = (leaf(B, S, W), leaf(B, S, W), leaf(B, S, W), leaf(W))
        units = _saved_bytes(lambda: TR.rglru_scan(*args, c=8.0, chunk=256)) / (B * S * W * 4)
    assert units <= limit, units


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tiles", list(zip(RGLRU_SHAPES, RGLRU_TILES)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_scan_matches_reference(jref, shape, tiles, dtype):
    a, b, h0 = _rglru_inputs(*shape)
    ja, jb = (jref.jnp.asarray(x).astype(dtype) for x in (a, b))
    exp_kernel = jref.ops.rglru_scan(ja, jb, jref.jnp.asarray(h0), chunk=tiles[0],
                                     block_w=tiles[1])
    exp_ref = jref.ref.ref_linear_scan(ja.astype("float32"), jb.astype("float32"),
                                       jref.jnp.asarray(h0))
    tops.rglru_scan.launches = 0
    ys, hf = tops.rglru_scan(_t(a, dtype), _t(b, dtype), _t(h0))
    assert tops.rglru_scan.launches == 0      # CPU tensors never reach the kernel
    assert ys.dtype == getattr(torch, dtype) and hf.dtype == torch.float32
    plain = tref.ref_linear_scan(_t(a, dtype), _t(b, dtype), _t(h0))
    for got_y, got_h in ((ys, hf), plain):
        for exp_y, exp_h in (exp_kernel, exp_ref):
            np.testing.assert_allclose(_np(got_y), np.asarray(exp_y, np.float32),
                                       **_rglru_tol(dtype))
            np.testing.assert_allclose(_np(got_h), np.asarray(exp_h), **_rglru_tol(dtype))


@pytest.mark.parametrize("chunk", [8, 16, 32, 64, 48])
def test_rglru_chunked_plain_path_matches_oracle(jref, chunk):
    """The model's chunked plain path (the associative scan inside each chunk) is
    invariant to the chunk and equals the step-by-step recurrence, as
    tests/test_kernels.py::test_rglru_chunking_property holds the kernel."""
    rng = np.random.default_rng(7)
    u, a_gate, x_gate = (rng.standard_normal((2, 64, 32), dtype=np.float32) for _ in range(3))
    a_param = rng.uniform(4.0, 9.0, 32).astype(np.float32)
    ys, hf = TR.rglru_scan(_t(u), _t(a_gate), _t(x_gate), _t(a_param), c=8.0, chunk=chunk)
    at, bt = TR.recurrence_inputs(_t(a_param), _t(a_gate), _t(x_gate), _t(u), 8.0)
    at, bt, h0 = at.numpy(), bt.numpy(), np.zeros((2, 32), np.float32)   # alive until JAX is done
    exp_y, exp_h = jref.ref.ref_linear_scan(at, bt, h0)
    np.testing.assert_allclose(ys.numpy(), np.asarray(exp_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(exp_h), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Mamba selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tiles", list(zip(MAMBA_SHAPES, MAMBA_TILES)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_scan_matches_reference(jref, shape, tiles, dtype):
    u, dt, A, Bm, Cm = _mamba_inputs(*shape)
    ju, jdt, jB, jC = (jref.jnp.asarray(x).astype(dtype) for x in (u, dt, Bm, Cm))
    jA = jref.jnp.asarray(A)
    exp_kernel = jref.ops.mamba_scan(ju, jdt, jA, jB, jC, chunk=tiles[0], block_d=tiles[1])
    exp_ref = jref.ref.ref_selective_scan(ju, jdt, jA, jB, jC)
    tu, tdt, tB, tC = (_t(x, dtype) for x in (u, dt, Bm, Cm))
    tops.mamba_scan.launches = 0
    y, hf = tops.mamba_scan(tu, tdt, _t(A), tB, tC)
    assert tops.mamba_scan.launches == 0      # CPU tensors never reach the kernel
    assert y.dtype == getattr(torch, dtype) and hf.dtype == torch.float32
    plain = tref.ref_selective_scan(tu, tdt, _t(A), tB, tC)
    for got_y, got_h in ((y, hf), plain):
        for exp_y, exp_h in (exp_kernel, exp_ref):
            np.testing.assert_allclose(_np(got_y), np.asarray(exp_y, np.float32),
                                       **_mamba_tol(dtype))
            np.testing.assert_allclose(_np(got_h), np.asarray(exp_h), **_mamba_tol(dtype))


def test_mamba_scan_state_carry(jref):
    """Splitting a sequence across two calls with the carried state equals
    one long call (the decode/prefill contract), and the JAX kernel's."""
    u, dt, A, Bm, Cm = (_t(x) for x in _mamba_inputs(1, 64, 32, 8, seed=3))
    y_full, h_full = tops.mamba_scan(u, dt, A, Bm, Cm)
    h = 32
    y1, h1 = tops.mamba_scan(u[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h])
    y2, h2 = tops.mamba_scan(u[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-5, atol=1e-5)
    exp_y, exp_h = jref.ops.mamba_scan(*(jref.jnp.asarray(t.numpy()) for t in (u, dt, A, Bm, Cm)),
                                       chunk=16, block_d=32)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(exp_y), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(exp_h), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64, 24])
def test_mamba_chunked_plain_path_matches_oracle(jref, chunk):
    """The model's chunked plain path equals the step-by-step oracle for
    any chunk, and carries a given state."""
    u, dt, A, Bm, Cm = _mamba_inputs(2, 48, 32, 8, seed=5)
    h0 = np.random.default_rng(6).standard_normal((2, 32, 8), dtype=np.float32)
    y, hf = TS.selective_scan(*(_t(x) for x in (u, dt, A, Bm, Cm)), chunk=chunk, h0=_t(h0))
    exp_y, exp_h = jref.ref.ref_selective_scan(u, dt, A, Bm, Cm, h0=h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(exp_y), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(exp_h), rtol=5e-5, atol=5e-5)


def test_scan_wrappers_reject_bad_shapes_and_devices():
    u, dt, A, Bm, Cm = (_t(x) for x in _mamba_inputs(1, 8, 16, 8))
    with pytest.raises(ValueError, match="Bm"):
        tops.mamba_scan(u, dt, A, Bm[:, :, :2], Cm)
    with pytest.raises(ValueError, match="CUDA device"):
        tops.mamba_scan(*(t.to("meta") for t in (u, dt, A, Bm, Cm)))   # no fallback off the CPU
    a, b, h0 = (_t(x) for x in _rglru_inputs(1, 8, 16))
    with pytest.raises(ValueError, match="h0"):
        tops.rglru_scan(a, b, h0[:, :8])
    with pytest.raises(ValueError, match="CUDA device"):
        tops.rglru_scan(*(t.to("meta") for t in (a, b, h0)))


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", RGLRU_SHAPES + [(2, 100, 200), (1, 17, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rglru_kernel_matches_plain(cuda, shape, dtype):
    a, b, h0 = (_t(x, "float32", cuda) for x in _rglru_inputs(*shape))
    a, b = a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype))
    tops.rglru_scan.launches = 0
    ys, hf = tops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert tops.rglru_scan.launches == 1
    exp_y, exp_h = tref.ref_linear_scan(a, b, h0)
    np.testing.assert_allclose(_np(ys), _np(exp_y), **_rglru_tol(dtype))
    np.testing.assert_allclose(_np(hf), _np(exp_h), **_rglru_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAMBA_SHAPES + [(2, 100, 200, 16), (1, 33, 130, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strided", [False, True])
def test_cuda_mamba_kernel_matches_plain(cuda, shape, dtype, strided):
    """`strided`: Bm and Cm are slices of one (B, S, 8 + 2N) projection, as
    on the main path."""
    _check_cuda_mamba(cuda, shape, dtype, strided)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 64, 16), (1, 1, 3, 8),     # one step
                                   (1, 17, 3, 8), (2, 40, 1, 16),    # D below a lane group
                                   (2, 50, 100, 16), (1, 31, 65, 8),  # D off the block's channels
                                   (3, 16, 130, 16)])                 # S one chunk
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strided", [False, True])
def test_cuda_mamba_kernel_ragged_edges(cuda, shape, dtype, strided):
    """The lane groups' edges: S = 1 and S off the 16-step chunk; D below
    one group's lanes and off the block's channels; N 8 and 16."""
    _check_cuda_mamba(cuda, shape, dtype, strided)


def _check_cuda_mamba(cuda, shape, dtype, strided):
    u, dt, A, Bm, Cm = (_t(x, "float32", cuda) for x in _mamba_inputs(*shape))
    u, dt, Bm, Cm = (t.to(getattr(torch, dtype)) for t in (u, dt, Bm, Cm))
    if strided:
        N = A.shape[1]
        proj = torch.cat([torch.zeros_like(Bm[..., :1]).expand(-1, -1, 8), Bm, Cm], dim=-1)
        Bm, Cm = proj[..., 8:8 + N], proj[..., 8 + N:]
        assert Bm.stride(1) == 8 + 2 * N
    h0 = torch.randn((shape[0], shape[2], shape[3]), device=cuda)
    tops.mamba_scan.launches = 0
    y, hf = tops.mamba_scan(u, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert tops.mamba_scan.launches == 1
    exp_y, exp_h = tref.ref_selective_scan(u, dt, A, Bm, Cm, h0)
    np.testing.assert_allclose(_np(y), _np(exp_y), **_mamba_tol(dtype))
    np.testing.assert_allclose(_np(hf), _np(exp_h), **_mamba_tol(dtype))


@pytest.mark.cuda
def test_cuda_mamba_kernel_state_carry(cuda):
    u, dt, A, Bm, Cm = (_t(x, "float32", cuda) for x in _mamba_inputs(2, 64, 96, 16, seed=3))
    y_full, h_full = tops.mamba_scan(u, dt, A, Bm, Cm)
    y1, h1 = tops.mamba_scan(u[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32])
    y2, h2 = tops.mamba_scan(u[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], h0=h1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h2), _np(h_full), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 17, 33])
def test_cuda_mamba_kernel_state_carry_ragged(cuda, split):
    """N = 8, D off the block's channels, splits off the chunk: the state
    carried across two calls gives what one call gives."""
    u, dt, A, Bm, Cm = (_t(x, "float32", cuda) for x in _mamba_inputs(2, 50, 70, 8, seed=4))
    tops.mamba_scan.launches = 0
    y_full, h_full = tops.mamba_scan(u, dt, A, Bm, Cm)
    y1, h1 = tops.mamba_scan(u[:, :split], dt[:, :split], A, Bm[:, :split], Cm[:, :split])
    y2, h2 = tops.mamba_scan(u[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:], h0=h1)
    torch.cuda.synchronize()
    assert tops.mamba_scan.launches == 3
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h2), _np(h_full), rtol=1e-5, atol=1e-5)
