"""Attention decode over a global KV cache: the kernel wrapper
(`kernels.decode_attention.decode_attention_kernel`), its plain version and
its route in `models/attention.py::apply_attn`.

On the CPU the wrapper takes the plain version: the model's
`decode_attention` over the kv heads repeated to the query heads with the
prefix mask, bit for bit, and within tests/test_kernels.py's tolerances of
attention over the first `length` positions computed in float64; its
launch counter stays 0.  The `cuda` cases run the hand-written kernel
against the plain version on the card and skip without one, at the same
tolerances (bf16: p is rounded before the PV product in both, each split
against its own running max in the kernel), and tighter at the decode_kv
cells' shapes.  Every case also runs the counting case (k zero, v one-hot
along (t + b + h) mod D) against its exact output, which no longer holds
if one position below the length is left out or counted twice, or one past
it is read.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attention import (MAX_GROUP, MIN_SPLIT,  # noqa: E402
                                                  check_kernel_inputs, counting_exact,
                                                  counting_inputs, decode_attention_kernel,
                                                  plain_decode_attention, split_count)
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import init_tree  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

DTYPES = ["float32", "bfloat16"]
# the decode_kv cells: (B, T, Hkv, D, group) of qwen2-1.5b and ai21-jamba2-mini
CELLS = [(64, 6144, 2, 128, 6), (64, 6144, 8, 128, 4)]
CELL_LENGTHS = [4097, 6144]
# the coverage cases: one row, a ragged length across splits and tiles, the
# whole 700-row cache
COVERAGE_LENGTHS = [1, 77, 515, 700]
H100_SMS = 132


# at the cells' shapes a typical |o| is only ~0.02: 4x the widest error the
# card gave there (9.8e-4 in bf16, an ulp of o's rounding)
CELL_TOL = dict(rtol=4e-3, atol=4e-3)
# the counting case's exact output against o: f32 exact, bf16 within one
# rounding (2^-8); a position more or less moves some o[d] by D / length
COUNT_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _tol(dtype):
    # tests/test_kernels.py:12-14: bf16 rounds p before the PV product
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    return torch.device("cuda")


def _inputs(B, T, Hkv, D, group, dtype, device="cpu", seed=0):
    """q (B, 1, Hq, D); k, v (B, T, Hkv, D) as decode hands them over: the
    second layer's views of stacked (2, B, T, Hkv, D) caches."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dt)
    q = rn(B, 1, Hkv * group, D)
    return q, rn(2, B, T, Hkv, D)[1], rn(2, B, T, Hkv, D)[1]


def _f64_attention(q, k, v, length, scale):
    """Attention of q over the first `length` positions, in float64 from the
    same (rounded) inputs."""
    qd, kd, vd = (t.double().cpu().numpy() for t in (q, k, v))
    group = qd.shape[2] // kd.shape[2]
    kd = np.repeat(kd[:, :length], group, axis=2)
    vd = np.repeat(vd[:, :length], group, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    w = np.exp(s - s.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, vd)


# ---------------------------------------------------------------------------
# CPU: the plain route, the split-T cut, the checks, the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128, 160])
@pytest.mark.parametrize("group", [1, 4, 6, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrapper_is_the_models_decode_over_the_repeated_cache(D, group, dtype):
    B, T, Hkv = 2, 37, 2
    q, k, v = _inputs(B, T, Hkv, D, group, dtype)
    scale = D ** -0.5
    k0, v0 = k.clone(), v.clone()
    decode_attention_kernel.launches = 0
    for length in (1, 23, T):
        got = tops.decode_attention_kernel(q, k, v, length, scale)
        mask = torch.arange(T) < length
        want = A.decode_attention(q, A._repeat_kv(k, group), A._repeat_kv(v, group), mask, scale)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got, want)
        assert torch.equal(plain_decode_attention(q, k, v, length, scale), want)
        np.testing.assert_allclose(got.double().numpy(), _f64_attention(q, k, v, length, scale),
                                   **_tol(dtype))
    assert decode_attention_kernel.launches == 0      # CPU tensors never reach the kernel
    assert torch.equal(k, k0) and torch.equal(v, v0)


@pytest.mark.parametrize("D,length", [(D, n) for D in HEAD_DIMS for n in COVERAGE_LENGTHS]
                         + [(CELLS[0][3], n) for n in CELL_LENGTHS])
def test_counting_case_is_exact_and_sees_one_position(D, length):
    """The counting case's exact output is the one-hot rows below `length`
    summed in float64 and the plain route's in f32; at the `cuda` cases'
    head dims and lengths the outputs of one position fewer or more differ
    from it beyond COUNT_RTOL, so their check of the kernel fails on either."""
    B, T, Hkv, G = 2, CELLS[0][1], 2, 6
    q, k, _ = _inputs(B, T, Hkv, D, G, "float32")
    kc, vc = counting_inputs(k)
    exact = counting_exact(B, Hkv * G, G, D, length, "cpu")
    summed = vc[:, :length].double().sum(1).repeat_interleave(G, dim=1)[:, None] / length
    assert torch.equal(kc, torch.zeros_like(k)) and torch.equal(summed, exact)
    got = decode_attention_kernel(q, kc, vc, length, D ** -0.5).double()
    torch.testing.assert_close(got, exact, rtol=COUNT_RTOL["float32"], atol=0)
    for other in (length - 1, length + 1):
        if 1 <= other <= T:
            off = counting_exact(B, Hkv * G, G, D, other, "cpu")
            for dtype in DTYPES:
                assert not torch.allclose(off, exact, rtol=COUNT_RTOL[dtype], atol=0)


@pytest.mark.parametrize("B,Hkv,length", [(64, 2, 4097), (64, 2, 6144), (64, 8, 4097),
                                          (64, 8, 6144), (4, 2, 2049), (4, 8, 2111),
                                          (1, 1, 1), (3, 2, 300), (2, 16, 100_000),
                                          (1024, 8, 513), (7, 1, 255), (5, 3, 257)])
def test_split_count_covers_the_length_in_nonempty_splits(B, Hkv, length):
    splits, chunk = split_count(B, Hkv, length, H100_SMS)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < length <= splits * chunk     # the last split holds a row
    assert splits == 1 or chunk >= MIN_SPLIT // 2
    if length >= MIN_SPLIT * 16:
        assert B * Hkv * splits >= 4 * H100_SMS               # several waves of blocks


def test_split_count_fills_the_card_at_the_cells_shapes():
    """qwen2-1.5b's 128 (session, kv head) pairs would fill one wave; the
    cut makes ~9 blocks of each, Jamba's 512 pairs 3."""
    assert split_count(64, 2, 4097, H100_SMS) == (9, 456)
    assert split_count(64, 8, 4097, H100_SMS) == (3, 1366)
    assert split_count(64, 2, 6144, H100_SMS)[0] == 9


@pytest.mark.parametrize("case", ["q_two_rows", "q_3d", "v_shape", "batch", "head_dim",
                                  "groups", "length_0", "length_past_T", "meta", "mixed"])
def test_wrapper_rejects_bad_shapes_lengths_and_devices(case):
    q, k, v = _inputs(2, 16, 2, 64, 4, "float32")
    args = dict(q=q, k=k, v=v, length=5, scale=0.125)
    bad = {"q_two_rows": dict(q=torch.cat([q, q], dim=1)), "q_3d": dict(q=q[:, 0]),
           "v_shape": dict(v=v[:, :8]), "batch": dict(q=q[:1]), "head_dim": dict(q=q[..., :32]),
           "groups": dict(q=q[:, :, :7]), "length_0": dict(length=0),
           "length_past_T": dict(length=17),
           "meta": {n: t.to("meta") for n, t in args.items() if torch.is_tensor(t)},
           "mixed": dict(k=k.to("meta"))}[case]
    with pytest.raises(ValueError):
        decode_attention_kernel(**{**args, **bad})


@pytest.mark.parametrize("length", [torch.tensor(5), 5.0, True])
def test_wrapper_takes_only_a_python_int_length(length):
    q, k, v = _inputs(2, 16, 2, 64, 4, "float32")
    with pytest.raises(TypeError):
        decode_attention_kernel(q, k, v, length, 0.125)


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("mixed_dtype", TypeError), ("head_dim_48", ValueError),
    ("group_17", ValueError), ("q_last_dim_strided", ValueError),
    ("k_misaligned", ValueError), ("v_row_stride", ValueError), ("empty", ValueError)])
def test_kernel_input_checks_refuse(case, error):
    """What the kernel does not take is refused before a launch (the checks
    run on CPU tensors here; the wrapper makes them for CUDA tensors)."""
    q, k, v = _inputs(2, 16, 2, 64, 4, "bfloat16")
    flat = torch.zeros(k.numel() + 8, dtype=k.dtype)
    bad = {"float16": dict(q=q.half(), k=k.half(), v=v.half()),
           "mixed_dtype": dict(k=k.float()),
           "head_dim_48": dict(q=q[..., :48], k=k[..., :48], v=v[..., :48]),
           "group_17": dict(q=torch.zeros(2, 1, 34, 64, dtype=q.dtype)),
           "q_last_dim_strided": dict(q=q.transpose(2, 3).contiguous().transpose(2, 3)),
           "k_misaligned": dict(k=flat[1:1 + k.numel()].view(k.shape)),
           "v_row_stride": dict(v=torch.zeros(2, 16, 2, 68, dtype=v.dtype)[..., :64]),
           "empty": dict(q=q[:0], k=k[:0], v=v[:0])}[case]
    with pytest.raises(error):
        check_kernel_inputs(**{**dict(q=q, k=k, v=v), **bad})


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 3, MAX_GROUP])
def test_kernel_takes_the_stacked_caches_views(D, group):
    """The decode branch's arguments (q from the projection, the caches'
    per-layer views, uncopied) pass the checks at every head dim."""
    check_kernel_inputs(*_inputs(2, 16, 2, D, group, "bfloat16"))
    check_kernel_inputs(*_inputs(2, 16, 2, D, group, "float32"))


def test_build_names_the_decode_kernel():
    assert "decode_attention" in build.SOURCES
    assert build.source("decode_attention").name == "decode_attention.cu"
    assert build.library_path("decode_attention").name.startswith("decode_attention-")


def test_cpu_decode_never_reaches_the_kernel():
    """With `use_pallas` the CPU's decode keeps the plain path (the mask
    over the cache), and the kernel's counter stays 0."""
    cfg = dataclasses.replace(treg.reduced(treg.get_config("qwen2-1.5b")), use_pallas=True)
    params = init_tree(TT.build_descriptors(cfg), torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
    plain = dataclasses.replace(cfg, use_pallas=False)
    _, caches = tsteps.make_prefill_step(plain)(params, {"tokens": toks[:, :8]})
    caches = tserve.grow_caches(caches, 8, 12)
    decode_attention_kernel.launches = 0
    with torch.no_grad():
        got, _ = TT.decode_step(cfg, params, _clone(caches), toks[:, 8:9].int(), 8)
        want, _ = TT.decode_step(plain, params, _clone(caches), toks[:, 8:9].int(), 8)
    assert decode_attention_kernel.launches == 0
    assert torch.equal(got, want)


def _clone(tree):
    if isinstance(tree, dict):
        return {n: _clone(t) for n, t in tree.items()}
    if isinstance(tree, list):
        return [_clone(t) for t in tree]
    return tree.clone()


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version
# ---------------------------------------------------------------------------

def _check_cuda(cuda, B, T, Hkv, D, group, dtype, lengths, seed=0, tol=None):
    """The kernel against the plain version at `tol` (`_tol(dtype)` by
    default), and on the counting case against its exact output."""
    q, k, v = _inputs(B, T, Hkv, D, group, dtype, cuda, seed)
    k0, v0 = k.clone(), v.clone()
    kc, vc = counting_inputs(k)
    scale = D ** -0.5
    for length in lengths:
        splits, _ = split_count(B, Hkv, length, torch.cuda.get_device_properties(cuda)
                                .multi_processor_count)
        before = decode_attention_kernel.launches
        got = decode_attention_kernel(q, k, v, length, scale)
        want = plain_decode_attention(q, k, v, length, scale)
        torch.cuda.synchronize()
        assert decode_attention_kernel.launches - before == (1 if splits == 1 else 2)
        assert got.dtype == q.dtype and got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), **(tol or _tol(dtype)))
        counted = decode_attention_kernel(q, kc, vc, length, scale).double()
        torch.testing.assert_close(counted, counting_exact(B, Hkv * group, group, D, length, cuda),
                                   rtol=COUNT_RTOL[dtype], atol=0)
    assert torch.equal(k, k0) and torch.equal(v, v0)           # the cache is not written


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Hkv,D,group", CELLS)
def test_cuda_kernel_matches_plain_at_the_cells_shapes(cuda, B, T, Hkv, D, group):
    _check_cuda(cuda, B, T, Hkv, D, group, "bfloat16", CELL_LENGTHS, tol=CELL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 3, 4, 6, 7, MAX_GROUP])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain_over_its_coverage(cuda, D, group, dtype):
    """Every head dim and group the kernel takes: one row, a ragged length
    across splits and tiles, the whole cache."""
    _check_cuda(cuda, 3, COVERAGE_LENGTHS[-1], 2, D, group, dtype, COVERAGE_LENGTHS,
                seed=D + group)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_reads_nothing_past_length(cuda, dtype):
    """The kernel does not read the slots at or past `length` (the plain
    version reads them all and weights them 0: an inf there makes it NaN)."""
    q, k, v = _inputs(4, 3000, 2, 128, 6, dtype, cuda)
    want = decode_attention_kernel(q, k, v, 2049, 0.0883)
    k[:, 2049:], v[:, 2049:] = float("nan"), float("inf")
    assert torch.equal(decode_attention_kernel(q, k, v, 2049, 0.0883), want)


@pytest.mark.cuda
def test_cuda_kernel_never_waits_on_the_host(cuda):
    q, k, v = _inputs(64, 4200, 2, 128, 6, "bfloat16", cuda)
    decode_attention_kernel(q, k, v, 4097, 0.0883)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for length in (4098, 4099, 1):
            decode_attention_kernel(q, k, v, length, 0.0883)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _served(cfg, device, plain: bool, monkeypatch, steps=4, P=40):
    """Prefill 4 prompts of P tokens, grow the caches, decode `steps`
    greedy tokens; with `plain`, the kernel's route takes the plain version
    instead.  -> (tokens (4, steps), logits of each step, the route's calls)."""
    params = init_tree(TT.build_descriptors(cfg), torch.Generator(device=device).manual_seed(0),
                       device, dtype=getattr(torch, cfg.compute_dtype))
    toks = torch.randint(0, cfg.vocab, (4, P), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    calls = []
    kernel = tops.decode_attention_kernel
    with monkeypatch.context() as mp:
        mp.setattr(tops, "decode_attention_kernel",
                   lambda *a: calls.append(a[3]) or (plain_decode_attention if plain
                                                     else kernel)(*a))
        with torch.no_grad():
            logits, caches = TT.prefill(cfg, params, toks)
            caches = tserve.grow_caches(caches, P, P + steps)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out, steps_logits = [], []
            for i in range(steps):
                step_logits, caches = TT.decode_step(cfg, params, caches, tok, P + i)
                tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
                out.append(tok)
                steps_logits.append(step_logits.float())
    return torch.cat(out, dim=1), steps_logits, calls


def _reduced(arch):
    """Reduced `arch` through the kernels; ai21-jamba2-mini as
    tests/test_torch_jamba.py serves it (two blocks of 8 layers, 4 of its 8
    experts held)."""
    cfg = dataclasses.replace(treg.reduced(treg.get_config(arch)), use_pallas=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, blocks=tuple((p, 2) for p, _ in cfg.blocks),
                                  moe=dataclasses.replace(cfg.moe, n_held=4, first_held=2))
    return cfg


@pytest.mark.cuda
def test_cuda_reduced_qwen2_decodes_the_same_tokens_through_the_kernel(cuda, monkeypatch):
    """f32: the kernel's route and the plain one agree on every greedy token
    and within 1e-4 on the logits; one call a layer a step, at each step's
    position + 1."""
    cfg = dataclasses.replace(_reduced("qwen2-1.5b"), compute_dtype="float32")
    got, got_logits, calls = _served(cfg, cuda, False, monkeypatch)
    want, want_logits, _ = _served(cfg, cuda, True, monkeypatch)
    assert torch.equal(got, want)
    for a, b in zip(got_logits, want_logits):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    layers = len(calls) // 4
    assert layers and calls == [40 + i + 1 for i in range(4) for _ in range(layers)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "ai21-jamba2-mini"])
def test_cuda_reduced_models_decode_the_same_tokens_in_bf16(cuda, monkeypatch, arch):
    """bf16, as served: the logits of the two routes within the repo's
    decode-vs-prefill tolerance (5e-2), and the same greedy token wherever
    the plain route's best logit leads the next by more than twice that."""
    cfg = dataclasses.replace(_reduced(arch), compute_dtype="bfloat16")
    got, got_logits, calls = _served(cfg, cuda, False, monkeypatch)
    want, want_logits, _ = _served(cfg, cuda, True, monkeypatch)
    assert calls
    for i, (a, b) in enumerate(zip(got_logits, want_logits)):
        torch.testing.assert_close(a, b, rtol=5e-2, atol=5e-2)
        top2 = torch.topk(b[:, 0], 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 0.1
        assert torch.equal(got[clear, i], want[clear, i])
        if not torch.equal(got[:, i], want[:, i]):
            break                   # past a near-tie the two sessions' inputs differ
