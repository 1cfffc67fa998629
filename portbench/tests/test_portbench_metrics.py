"""The metrics' arithmetic: window rates, tails over all requests, the
device's busy union, and the copied roofline and FLOP formulas."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.harness import roofline, stats  # noqa: E402
from portbench.harness.spec import load_module  # noqa: E402
from portbench.harness.trace import SLICE, Trace  # noqa: E402
from portbench.reference import dense_gqa, mamba1  # noqa: E402

PEAK = roofline.DEFAULT_PEAKS
QWEN = json.loads((ROOT / "portbench/configs/qwen2-1.5b.json").read_text())
FALCON = json.loads((ROOT / "portbench/configs/falcon-mamba-7b.json").read_text())


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


class Rec:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_window_rate_counts_all_work_over_all_time():
    assert stats.window_rate(300, 10.0, 13.0) == 100.0
    batches = [{"B": 16, "S": 1024, "t_issue": 0.0, "t_done": 0.5},
               {"B": 1, "S": 16384, "t_issue": 0.5, "t_done": 1.5}]
    rec = Rec(window={"t0": 0.0, "t1": 2.0, "batches": batches})
    assert reader("prompt_tokens_per_s").read(rec) == 32768 / 2.0


def test_p95_is_over_every_request_not_medians_of_chunks():
    # 31 requests a cycle: 16 at 100 ms, 8 at 110, 4 at 120, 2 at 150, 1 at 200
    batches = []
    t = 0.0
    for B, ms in ((16, 100), (8, 110), (4, 120), (2, 150), (1, 200)):
        batches.append({"B": B, "S": 16384 // B, "t_issue": t, "t_done": t + ms / 1e3})
        t += ms / 1e3
    got = reader("ttft_ms_p95").read(Rec(window={"batches": batches}))
    # rank 0.95 * 30 = 28.5 of 31 sorted values: between the 150s and the 200
    assert got == pytest.approx(150.0, abs=1e-9)
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    per_batch = sorted(b["t_done"] - b["t_issue"] for b in batches)
    assert stats.percentile([x * 1e3 for x in per_batch], 95) > got   # a batch-level tail differs


def test_union_counts_overlap_once_and_clips_to_the_slice():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 2), (1, 3), (5, 6)], lo=1.5, hi=5.5) == 2.0
    assert stats.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


def test_trace_busy_idle_and_launches_from_one_slice():
    ev = [{"name": SLICE, "cat": "user_annotation", "ts": 0, "dur": 1000},
          {"name": "flash_bf16_kernel<128>", "cat": "kernel", "ts": 100, "dur": 200},
          {"name": "gemm", "cat": "kernel", "ts": 200, "dur": 200},
          {"name": "Memcpy DtoD", "cat": "gpu_memcpy", "ts": 700, "dur": 100},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 90, "dur": 5},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 95, "dur": 5},
          {"name": "aten::copy_", "cat": "cpu_op", "ts": 450, "dur": 200}]
    t = Trace(ev)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.launches == 2
    assert [k[2] for k in t.kernels("flash_")] == ["flash_bf16_kernel<128>"]
    assert t.idle_gaps()[0] == ["aten::copy_", pytest.approx(300e-6)]
    idle = reader("idle_share.prefill").read(Rec(trace=t))
    assert idle == pytest.approx(60.0)


def test_flash_bound_matches_the_chip_smoke_figure():
    # PERF.md: qwen2-1.5b (4, 12, 2, 2048, 128) causal bf16, bound 0.0521 ms (operations)
    f, n = roofline.flash_cost(4, 12, 2, 2048, 128)
    assert roofline.bound_s(f, n, PEAK["bf16_flops"], PEAK["hbm_bytes"]) * 1e3 == \
        pytest.approx(0.05213829461678463, rel=1e-12)
    assert roofline.attended_pairs(2048) == sum(r + 1 for r in range(2048))


def test_mamba_scan_bound_matches_the_chip_smoke_figure():
    # PERF.md: falcon-mamba-7b (4, 2048, 8192, 16) bf16, bound 0.1211 ms (bytes)
    f, n = roofline.mamba_scan_cost(4, 2048, 8192, 16)
    assert n / PEAK["hbm_bytes"] > f / PEAK["f32_flops"]
    assert roofline.bound_s(f, n, PEAK["f32_flops"], PEAK["hbm_bytes"]) * 1e3 == \
        pytest.approx(0.12113400358208955, rel=1e-12)


def test_flash_roofline_reads_each_launch_at_its_batch_shape():
    ev = [{"name": SLICE, "cat": "user_annotation", "ts": 0, "dur": 10_000}]
    ev += [{"name": "flash_bf16_kernel<128>", "cat": "kernel", "ts": 10 + 100 * i, "dur": 50}
           for i in range(4)]
    batches = [{"B": 16, "S": 1024, "launches": {"flash_attention": 2}},
               {"B": 1, "S": 16384, "launches": {"flash_attention": 2}}]
    rec = Rec(trace=Trace(ev), slice={"batches": batches}, reference=dense_gqa, conf=QWEN,
              peaks=PEAK)
    want = sum(2 * roofline.bound_s(*roofline.flash_cost(b["B"], 12, 2, b["S"], 128),
                                    PEAK["bf16_flops"], PEAK["hbm_bytes"]) for b in batches)
    assert reader("flash_roofline").read(rec) == pytest.approx(100 * want / 200e-6)
    batches[0]["launches"]["flash_attention"] = 3            # the counts disagree: no reading
    assert reader("flash_roofline").read(rec) is None


def test_parameter_counts_match_the_port():
    """matmul_params is the port's whole count less the tables, the norms'
    scales, the biases and Mamba's per-channel leaves (conv, dt bias,
    A_log, D)."""
    from repro_torch.configs import registry
    rest = {"qwen2-1.5b": 28 * ((12 + 2 + 2) * 128 + 2 * 1536) + 1536,
            "falcon-mamba-7b": 64 * (4 * 8192 + 8192 + 8192 + 8192 * 16 + 8192 + 4096) + 4096}
    for conf, ref, arch in ((QWEN, dense_gqa, "qwen2-1.5b"), (FALCON, mamba1, "falcon-mamba-7b")):
        cfg = registry.get_config(arch)
        tables = cfg.vocab_padded * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        assert cfg.param_count() == tables + ref.matmul_params(conf) + rest[arch]


def test_prefill_flops_are_a_third_of_the_train_formula():
    """2 N per token and 4 Hq Dh per causal pair per attention layer: the
    forward third of `repro_torch.train.model_flops` (6 N and 12 Hq Dh),
    less the unembedding, which prefill runs at the last position only."""
    from repro_torch.configs import registry
    from repro_torch.train import model_flops
    cfg = registry.get_config("qwen2-1.5b")
    S = 4096
    train = model_flops(cfg, 1, S)
    unembed = 6.0 * cfg.vocab_padded * cfg.d_model * S       # tied: in N of the train formula
    pre = dense_gqa.prefill_flops(QWEN, 1, S) - 2.0 * QWEN["hidden_size"] * QWEN["vocab_size"]
    norms_biases = 6.0 * S * (cfg.param_count() - cfg.vocab_padded * cfg.d_model
                              - dense_gqa.matmul_params(QWEN))
    assert 3 * pre == pytest.approx(train - unembed - norms_biases, rel=1e-12)


def test_mfu_reader_over_the_window():
    batches = [{"B": 1, "S": 16384}]
    rec = Rec(window={"t0": 0.0, "t1": 1.0, "batches": batches}, reference=mamba1,
              conf=FALCON, peaks=PEAK)
    want = 100 * mamba1.prefill_flops(FALCON, 1, 16384) / PEAK["bf16_flops"]
    assert reader("prefill_mfu").read(rec) == pytest.approx(want)
    # per layer: in_proj 4096 x 16384, x_proj 8192 x 288, dt_proj 256 x 8192, out_proj 8192 x 4096
    assert mamba1.matmul_params(FALCON) == 64 * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096)


def test_decode_device_ms_per_step_is_the_busy_union_over_the_steps():
    ev = [{"name": SLICE, "cat": "user_annotation", "ts": 0, "dur": 1000},
          {"name": "mul", "cat": "kernel", "ts": 100, "dur": 300},
          {"name": "add", "cat": "kernel", "ts": 200, "dur": 300},
          {"name": "copy", "cat": "gpu_memcpy", "ts": 700, "dur": 100}]
    rec = Rec(trace=Trace(ev), slice={"steps": 2})
    assert reader("device_ms_per_step.decode").read(rec) == pytest.approx(0.5e3 * 500e-6)
    assert reader("device_ms_per_step.decode").read(Rec(trace=None, slice={"steps": 2})) is None


def test_on_a_card_the_slice_lies_between_the_marker_kernels():
    ev = [{"name": "gemm", "cat": "kernel", "ts": 0, "dur": 50, "args": {"correlation": 1}},
          {"name": "spin_kernel(long)", "cat": "kernel", "ts": 100, "dur": 2, "args": {"correlation": 2}},
          {"name": "gemm", "cat": "kernel", "ts": 110, "dur": 40, "args": {"correlation": 3}},
          {"name": "flash_bf16_kernel<128>", "cat": "kernel", "ts": 160, "dur": 20, "args": {"correlation": 4}},
          {"name": "spin_kernel(long)", "cat": "kernel", "ts": 198, "dur": 2, "args": {"correlation": 5}}]
    ev += [{"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 90 + i, "dur": 1,
            "args": {"correlation": i}} for i in range(1, 6)]
    t = Trace(ev)
    assert (t.t0, t.t1) == pytest.approx((100e-6, 200e-6))
    assert t.busy_s == pytest.approx(60e-6) and t.launches == 2
    assert [k[2] for k in t.kernels("flash_")] == ["flash_bf16_kernel<128>"]
