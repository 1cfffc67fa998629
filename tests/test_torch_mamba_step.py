"""The Mamba decode step's state update: the kernel wrapper
(`kernels.mamba_step.mamba_state_step`) and its plain version.

On the CPU the wrapper takes the plain version, which must equal the decode
branch of `models/ssm.py::apply_mamba` as it was written out before the
kernel existed (`_decode_arithmetic` below) bit for bit, and its launch
counter stays 0.  The `cuda` cases run the hand-written kernel against the
plain version on the card and skip without one.  Tolerances there: the
state's arithmetic is the plain step's, each product and sum rounded alike,
so only the exponential's rounding and the order of y's sum over N differ:
f32 within 1e-5 (relative and absolute, over 32 carried steps too); a bf16
y within one bf16 rounding of the plain step's f32 y (relative 2^-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.mamba_step import (check_kernel_inputs,  # noqa: E402
                                            mamba_state_step, plain_state_step)

DTYPES = ["float32", "bfloat16"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_Y_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
SERVING = (256, 8192, 16)                  # falcon-mamba-7b's decode_256: (B, d_inner, d_state)
DT_RANK = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the state kernel runs only on the card")
    return torch.device("cuda")


def _inputs(B, D, N, dtype, device="cpu", seed=0, dt_rank=DT_RANK, batch_minor=True):
    """h (B, D, N) f32; x, dt (B, 1, D) and Bm, Cm (B, 1, N) as the decode
    branch has them (x batch-minor, as the conv step leaves it, with
    `batch_minor`; Bm and Cm slices of one (B, 1, dt_rank + 2N) product);
    A_log (D, N) f32 as Mamba initialises it (log 1..N)."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)

    def t(a, dtype=dt_):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
    h = t(rng.standard_normal((B, D, N)), torch.float32)
    x = t(rng.standard_normal((B, 1, D)))
    if batch_minor:
        x = x.transpose(0, 2).contiguous().transpose(0, 2)          # strides (1, D B, B)
    dt = t(np.log1p(np.exp(rng.standard_normal((B, 1, D)) - 2.0)))        # softplus
    A_log = t(np.log(np.broadcast_to(np.arange(1, N + 1), (D, N))), torch.float32)
    proj = t(rng.standard_normal((B, 1, dt_rank + 2 * N)))
    return h, x, dt, A_log, proj[..., dt_rank:dt_rank + N], proj[..., dt_rank + N:]


def _decode_arithmetic(state, xc, dt, A_log, Bm, Cm):
    """`apply_mamba`'s decode state update as it was written inline: the
    cache's state written in place; y (B, 1, D) f32."""
    A = -torch.exp(A_log.float())
    dtf = dt.float()[:, 0]
    dA = torch.exp(dtf[..., None] * A[None])                       # (B, D, N)
    dBu = (dtf * xc.float()[:, 0])[..., None] * Bm.float()[:, 0, None, :]
    h_new = dA * state + dBu
    state.copy_(h_new)
    return torch.einsum("bdn,bn->bd", h_new, Cm.float()[:, 0])[:, None]


def _step_args(h, x, dt, A_log, Bm, Cm):
    """The wrapper's arguments as the decode branch passes them."""
    return h, x[:, 0], dt[:, 0], A_log, Bm[:, 0], Cm[:, 0]


# ---------------------------------------------------------------------------
# CPU: the plain version, the wrapper's checks, the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,D,N", [(2, 64, 16), (3, 40, 8), (1, 7, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrapper_is_the_decode_arithmetic_bit_for_bit(B, D, N, dtype):
    h, x, dt, A_log, Bm, Cm = _inputs(B, D, N, dtype)
    h_old = h.clone()
    y_old = _decode_arithmetic(h_old, x, dt, A_log, Bm, Cm)
    tops.mamba_state_step.launches = 0
    ptr = h.data_ptr()
    y = tops.mamba_state_step(*_step_args(h, x, dt, A_log, Bm, Cm))
    assert tops.mamba_state_step.launches == 0        # CPU tensors never reach the kernel
    assert h.data_ptr() == ptr and torch.equal(h, h_old)
    assert y.dtype == x.dtype and y.shape == (B, D)
    assert torch.equal(y, y_old[:, 0].to(x.dtype))
    h2 = h_old.clone()
    assert torch.equal(plain_state_step(*_step_args(h2, x, dt, A_log, Bm, Cm)),
                       _decode_arithmetic(h_old, x, dt, A_log, Bm, Cm)[:, 0])
    assert torch.equal(h2, h_old)


@pytest.mark.parametrize("case", ["h_2d", "x_width", "dt_batch", "A_log_shape", "Bm_states",
                                  "Cm_batch", "meta", "mixed"])
def test_wrapper_rejects_bad_shapes_and_devices(case):
    h, x, dt, A_log, Bm, Cm = _step_args(*_inputs(2, 32, 16, "float32"))
    args = dict(h=h, x=x, dt=dt, A_log=A_log, Bm=Bm, Cm=Cm)
    bad = {"h_2d": dict(h=h[:, :, 0]), "x_width": dict(x=x[:, :31]), "dt_batch": dict(dt=dt[:1]),
           "A_log_shape": dict(A_log=A_log[:, :8]), "Bm_states": dict(Bm=Bm[:, :8]),
           "Cm_batch": dict(Cm=Cm[:1]),
           "meta": {k: v.to("meta") for k, v in args.items()},      # no fallback off the CPU
           "mixed": dict(h=h.to("meta"))}[case]
    with pytest.raises(ValueError):
        mamba_state_step(**{**args, **bad})


@pytest.mark.parametrize("case,error", [
    ("x_float16", TypeError), ("dt_other_dtype", TypeError), ("h_bfloat16", TypeError),
    ("A_log_bfloat16", TypeError), ("h_not_contiguous", ValueError),
    ("h_misaligned", ValueError), ("A_log_not_contiguous", ValueError),
    ("d_state_4", ValueError), ("empty", ValueError)])
def test_kernel_input_checks_refuse(case, error):
    """What the kernel does not take is refused before a launch (the checks
    run on CPU tensors here; the wrapper makes them for CUDA tensors)."""
    h, x, dt, A_log, Bm, Cm = _step_args(*_inputs(2, 32, 16, "bfloat16"))
    args = dict(h=h, x=x, dt=dt, A_log=A_log, Bm=Bm, Cm=Cm)
    flat = torch.zeros(h.numel() + 4)
    bad = {"x_float16": dict(x=x.half(), dt=dt.half(), Bm=Bm.half(), Cm=Cm.half()),
           "dt_other_dtype": dict(dt=dt.float()), "h_bfloat16": dict(h=h.bfloat16()),
           "A_log_bfloat16": dict(A_log=A_log.bfloat16()),
           "h_not_contiguous": dict(h=h.transpose(0, 1).contiguous().transpose(0, 1)),
           "h_misaligned": dict(h=flat[1:1 + h.numel()].view(h.shape)),
           "A_log_not_contiguous": dict(A_log=A_log.t().contiguous().t()),
           "d_state_4": dict(h=h[..., :4].contiguous(), A_log=A_log[:, :4].contiguous(),
                             Bm=Bm[:, :4], Cm=Cm[:, :4]),
           "empty": dict(h=h[:0], x=x[:0], dt=dt[:0], Bm=Bm[:0], Cm=Cm[:0])}[case]
    with pytest.raises(error):
        check_kernel_inputs(**{**args, **bad})


@pytest.mark.parametrize("B,D,N", [(256, 64, 16), (3, 200, 8), (1, 64, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_takes_the_main_paths_views(B, D, N, dtype):
    """The decode branch's arguments (the cache's state, x and dt rows,
    Bm and Cm slices of the x_proj product at falcon-mamba-7b's dt_rank,
    uncopied) pass the checks."""
    check_kernel_inputs(*_step_args(*_inputs(B, D, N, dtype, dt_rank=256)))


def test_build_names_the_state_kernel_and_hashes_it(tmp_path, monkeypatch):
    """`build.SOURCES` names the new source, and its library's file name
    carries its hash: a changed source builds anew, and the other kernels'
    libraries keep their names."""
    assert "mamba_step" in build.SOURCES
    assert build.source("mamba_step").name == "mamba_step.cu"
    same = build.library_path("mamba_step")
    others = {n: build.library_path(n) for n in build.SOURCES if n != "mamba_step"}
    assert same.parent == build.BUILD_DIR and same.name.startswith("mamba_step-")
    src = build.source("mamba_step")
    for n in build.SOURCES:
        (tmp_path / f"{n}.cu").write_bytes(build.source(n).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("mamba_step") == same
    (tmp_path / src.name).write_bytes(src.read_bytes() + b"\n")
    assert build.library_path("mamba_step") != same
    assert {n: build.library_path(n) for n in others} == others


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version
# ---------------------------------------------------------------------------

def _check_cuda(cuda, B, D, N, dtype, steps=1, seed=0, batch_minor=True):
    h, x, dt, A_log, Bm, Cm = _inputs(B, D, N, dtype, cuda, seed, batch_minor=batch_minor)
    h_plain = h.clone()
    ptr = h.data_ptr()
    mamba_state_step.launches = 0
    for s in range(steps):
        if s:
            _, x, dt, _, Bm, Cm = _inputs(B, D, N, dtype, cuda, seed + s,
                                          batch_minor=batch_minor)
        y = mamba_state_step(*_step_args(h, x, dt, A_log, Bm, Cm))
        y_plain = plain_state_step(*_step_args(h_plain, x, dt, A_log, Bm, Cm))
        torch.cuda.synchronize()
        assert mamba_state_step.launches == s + 1
        assert h.data_ptr() == ptr and y.dtype == x.dtype and y.shape == (B, D)
        torch.testing.assert_close(h, h_plain, **F32_TOL)
        if dtype == "float32":
            torch.testing.assert_close(y, y_plain, **F32_TOL)
        else:
            torch.testing.assert_close(y.float(), y_plain.to(torch.bfloat16).float(),
                                       **BF16_Y_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,N", [SERVING,
                                   (3, 200, 8),      # N = 8; D off the 64- and 128-channel blocks
                                   (1, 8192, 16),    # B = 1
                                   (5, 130, 16),     # B off the 4-row groups
                                   (1, 3, 8)])       # D below a warp
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch_minor", [True, False])
def test_cuda_kernel_matches_plain(cuda, B, D, N, dtype, batch_minor):
    _check_cuda(cuda, B, D, N, dtype, batch_minor=batch_minor)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,N", [(8, 512, 16), (5, 72, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_carries_the_state_32_steps(cuda, B, D, N, dtype):
    _check_cuda(cuda, B, D, N, dtype, steps=32, seed=7)
