"""Smoke run of the PyTorch port on one NVIDIA GPU.

Phases, in order (any failure raises, and the script exits non-zero without
its last line):
  1. build every CUDA kernel of the port with nvcc (sm_90a), one nvcc per
     source, all started together, and print ptxas's report of each instance;
  2. hold each kernel against its plain PyTorch version on the card: flash
     attention (head_dim 16-256 and 160, GQA ratios 1, 2, 3, 4, 7 and 8, a
     window shorter than the prompt, bidirectional at 1500 frames), the
     Mamba selective scan and the RG-LRU scan, over the tests' shapes,
     ragged shapes and the serving shapes;
  3. check each of the ten archs on a small input (the reduced config, 2
     repeats per layer group), the kernel path on the card against the
     plain path on the CPU, with the MoE routing choices of the two runs
     compared;
  3a. train_small: one f32 train step (2 microbatches) of each of those
     reduced models on the card against the same step on the CPU, from the
     same weights and batch: loss, grad_norm and params after the step;
  3b. train: full-width qwen2-1.5b, bf16 compute on an f32 master copy,
     sequence 4096, global batch 8 in 4 microbatches, 6 steps: one line per
     step, then step ms, tokens/s, model-FLOPs share and peak memory; the
     losses are finite and fall, the first step's bf16 loss is within 5e-2
     of the same weights' and batch's f32 loss, peak memory is below 80 GB,
     and no kernel is launched while training (the kernels are
     forward-only; training runs the plain path);
  4. serve each arch at full width: full depth but for deepseek-v2-236b (1
     dense + 4 MoE layers of its 60) (bf16, the kernels in prefill): batch
     4, 2048-token prompts (whisper-large-v3: 1500 encoder frames and a
     384-token prompt), 64 new tokens; count each kernel's launches on
     each path; peak memory below 80 GB; check decode against prefill in
     bf16 and in f32 (MoE archs at the drop-free capacity, and logged at
     the published one with its drops; gemma3-27b's f32 at 8 of its 62
     layers, and once more at a 1500-token prompt, which the ring cache of
     its 1024-token window does not divide), and the bf16 logits against
     the f32 model's where that runs at full depth, each model freed
     before the next;
  4a. device_tier: the paper's scheduler on the card, on the host's clock:
     Workflow/Engine -> FalkonProvider -> FalkonService ->
     DeviceExecutorPool(device="cuda") -> `torch.func.vmap` bundles.  A
     MolDyn-sized stream of 20,480 `small_task`s (x (16, 192) f32, one
     shared w (192, 192)) at max_bundle 1, 4, 16, 64 and 256: wall s,
     tasks/s, device share, bundles and fused tasks for each; every task
     run and (above bundle 1) fused, every output finite, 256 sampled
     outputs against the same tasks run one at a time on the CPU; the
     stream again on two dispatchers (two threads, two CUDA streams)
     against one; 4,096 `attention_task`s (q, k, v (8, 256, 64) f32) at
     bundle 256, 64 sampled against the CPU; the predictor's seconds per
     task beside the measured ones; the reference benchmark's two targets
     (>= 5x tasks/s at bundle 256 over bundle 1, >= 80% of wall inside
     device execution at the best bundle) reported, not held; last, the
     card's busy seconds per task at bundles 1 and 256 (`torch.profiler`)
     and so its busy share; and no kernel launched, as the reference's
     device tier reaches no Pallas kernel;
  4b. trainer: full-width qwen2-1.5b through the engine-driven `Trainer`
     (every step, data stage, eval and checkpoint an engine task; bf16
     compute on an f32 master copy, sequence 4096, batch 2): run A takes
     steps 0-2 with two injected step faults, retried, and checkpoints the
     18.5 GB state at step 2, logging each leaf's float64 sum on the card;
     run B, a fresh Trainer on the same workdir, restores it and takes only
     steps 2 and 3.  Held: B's restored sums equal A's leaf by leaf, B's
     step-2 loss within 1e-4 (relative) of A's, finite losses, peak memory
     below 80 GB, and room on the disk for a checkpoint before one is
     written; logged: checkpoint and restore seconds and GB/s, the median
     step through the engine beside a bare `train()` step at the same
     batch;
  4c. reliability, with CUDA initialised in this process: the port's
     kill-and-resume benchmark at the reference's CI size (3,000 tasks,
     SIGKILL at 50%) under its own assertions, and a 2-shard
     `ProcessFederation` (spawned shard processes, sleep bodies) whose
     values and placement equal an in-process `FederatedEngine` under
     `SimClock`;
  4d. vmap_clustering: the port of the reference's clustering benchmark on
     the card under its own assertions (every task fused, >= 1.5x), fused
     outputs against per-task ones; no kernel is launched in 4b-4d;
  4d'. examples: the port's four example workflows (`repro_torch.examples`)
     on the card at the reference's default sizes, each against the same
     example on the CPU (f32 1e-5; flash 2e-5; the least-squares fit at
     rtol 1e-4): quickstart (its train step from weights drawn on the card,
     its flash call at (1, 4, 2, 128, 64), causal, window 64, also against
     `ref_attention`), moldyn twice on one workdir (the second run restores
     from its log, with the same energies) and once at the paper's 244
     molecules (4,881 tasks), montage (15 mDiffFit tasks) and fmri; each
     example's wall seconds and tasks/s logged with the card's name and
     power limit; the phase's launches are exactly quickstart's one flash
     call;
  4d''. train_memory: deepseek-v2-236b cut to 1 dense + 1 MoE layer at full
     width, one forward and backward (batch 1 x 4096, f32 parameters):
     `torch.cuda.max_memory_allocated` above the parameters beside
     `op_cost.analyze`'s count of live bytes for the same step on meta
     tensors, logged, not held; no kernel launched;
  4e. compression: gradient compression with error feedback on the card,
     at full-width qwen2-1.5b's gradient shapes (f32, one tensor per
     parameter leaf, 1.544 B elements from the generator; the largest
     leaf, the 151,936 x 1,536 embedding, drawn tie-free in |g|): 3 steps
     of int8, then 3 of top-k at 1%, each logged with its ms, GB/s over the
     f32 gradient bytes and compressed over f32 bytes.  Held: the largest
     leaf's q and scale (int8) and vals and idx (top-k) of the first step
     equal a CPU run of the same function on the same values, and every
     residual equals the input minus the decompressed value at 1e-6;
  4f. elastic: a one-rank NCCL process group and `make_mesh_for_dp(1)` on
     the card; full-width qwen2-1.5b's f32 parameters `reshard_tree`d onto
     it come back bit-equal; the seconds logged; the group destroyed;
  4g. dryrun: `python -m repro_torch.launch.dryrun` for qwen2-1.5b x
     train_4k, prefill_32k and decode_32k, falcon-mamba-7b x prefill_32k
     and granite-moe-3b-a800m x prefill_32k on the 16 x 16 fake world (the
     sharded step's four partitions of its own: query rows for heads that
     do not divide the model axis, split-T decode, batch-local MoE
     dispatch, Mamba's in_proj halves), one process per cell, started
     before 4e (the host traces them while the card compresses); each must
     exit 0; each cell's per-device GB, FLOPs, wire bytes, three roofline
     terms and dominant term are logged (H100 cluster predictions, not
     measurements); no kernel is launched in 4e-4g;
  5. time each kernel at its serving shape beside its bound, its plain
     version and, where one PyTorch call computes the same function, that
     call; for the kernels that take exponentials (flash attention, the
     Mamba scan), the SFU's floor for them at the SM clock that nvidia-smi
     reads while the kernel runs;
then print the `kernels` line (each serving shape's entry, and
quickstart's f32 call), the card's name and power limit, and
{"ok": true, "device": {...}} as the last line.

Run:  python3 chip_smoke.py        (needs one CUDA card and nvcc)
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 rate of the CUDA cores (no tensor cores)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bandwidth
SFU_EXP_PER_CLOCK = 16      # exponentials per clock per SM (CUDA guide, compute capability 9.0)
BATCH, PROMPT, NEW = 4, 2048, 64
ARCHS = ("qwen2-1.5b", "falcon-mamba-7b", "recurrentgemma-9b", "granite-moe-3b-a800m",
         "deepseek-v2-236b", "qwen1.5-0.5b", "stablelm-12b", "gemma3-27b", "qwen2-vl-7b",
         "whisper-large-v3")
# layer groups' repeats capped in the serving cell: deepseek-v2-236b's 471 GB
# of bf16 weights do not fit one card; 1 dense + 4 MoE layers are 34.6 GB
MAX_REPEATS = {"deepseek-v2-236b": 4}
# archs whose bf16 decode-vs-prefill is logged at 5e-2 but not held there:
# the rounding of 40 layers 5120 wide, on logits of RMS 1.43 (qwen2-1.5b's:
# 0.78), puts decode and prefill ~0.08 apart while each is ~0.1 from the
# f32 model of the same weights; `bf16_vs_f32` holds them instead (as it
# does every arch whose f32 check runs at full depth)
BF16_HELD_AGAINST_F32 = {
    "stablelm-12b": "bf16 rounding over 40 layers exceeds 5e-2: held by bf16_vs_f32"}
# archs whose f32 decode-vs-prefill check runs at 1 repeat per layer group,
# since their f32 weights do not fit the card
F32_CUT = {"deepseek-v2-236b": "1 dense + 1 MoE layer",
           "gemma3-27b": "8 of 62 layers: 5 local + 1 global, then 2 local"}
KERNELS = ("flash_attention", "mamba_scan", "rglru_scan")
# launches of each kernel in one full-width prefill (= one serve: decode is plain)
SERVE_LAUNCHES = {
    "qwen2-1.5b": {"flash_attention": 28, "mamba_scan": 0, "rglru_scan": 0},
    "falcon-mamba-7b": {"flash_attention": 0, "mamba_scan": 64, "rglru_scan": 0},
    "recurrentgemma-9b": {"flash_attention": 12, "mamba_scan": 0, "rglru_scan": 26},
    "granite-moe-3b-a800m": {"flash_attention": 32, "mamba_scan": 0, "rglru_scan": 0},
    "deepseek-v2-236b": {"flash_attention": 0, "mamba_scan": 0, "rglru_scan": 0},
    "qwen1.5-0.5b": {"flash_attention": 24, "mamba_scan": 0, "rglru_scan": 0},
    "stablelm-12b": {"flash_attention": 40, "mamba_scan": 0, "rglru_scan": 0},
    # 52 local and 10 global layers
    "gemma3-27b": {"flash_attention": 62, "mamba_scan": 0, "rglru_scan": 0},
    "qwen2-vl-7b": {"flash_attention": 28, "mamba_scan": 0, "rglru_scan": 0},
    # 32 encoder and 32 decoder self-attention layers; cross-attention is plain
    "whisper-large-v3": {"flash_attention": 64, "mamba_scan": 0, "rglru_scan": 0},
}
# the kernels' shapes in those prefills
SERVE_SHAPE = dict(B=BATCH, Hq=12, Hkv=2, S=PROMPT, D=128)        # qwen2-1.5b attention
LOCAL_SHAPE = dict(B=BATCH, Hq=16, Hkv=1, S=PROMPT, D=256)        # recurrentgemma-9b local layers
GRANITE_SHAPE = dict(B=BATCH, Hq=24, Hkv=8, S=PROMPT, D=64)       # granite-moe-3b-a800m attention
LOCAL_WINDOW = 2048
QWEN15_SHAPE = dict(B=BATCH, Hq=16, Hkv=16, S=PROMPT, D=64)       # qwen1.5-0.5b
STABLELM_SHAPE = dict(B=BATCH, Hq=32, Hkv=8, S=PROMPT, D=160)     # stablelm-12b
GEMMA3_SHAPE = dict(B=BATCH, Hq=32, Hkv=16, S=PROMPT, D=128)      # gemma3-27b, local and global
GEMMA3_WINDOW = 1024
QWEN2VL_SHAPE = dict(B=BATCH, Hq=28, Hkv=4, S=PROMPT, D=128)      # qwen2-vl-7b, GQA ratio 7
WHISPER_ENC_SHAPE = dict(B=BATCH, Hq=20, Hkv=20, S=1500, D=64)    # whisper-large-v3's encoder
GEMMA3_RAGGED_PROMPT = 1500     # 1500 mod 1024 = 476: the ring repair's case
MAMBA_SHAPE = dict(B=BATCH, S=PROMPT, D=8192, N=16)               # falcon-mamba-7b, dt_rank 256
MAMBA_DT_RANK = 256
RGLRU_SHAPE = dict(B=BATCH, S=PROMPT, W=4096)                     # recurrentgemma-9b, f32 a and b
# the device tier: the paper's 20,497 MolDyn jobs (benchmarks/million_tasks.py:4)
# rounded to 80 bundles of 256
TIER_TASKS, TIER_SAMPLES = 20480, 256
TIER_ATTN_TASKS, TIER_ATTN_SHAPE, TIER_ATTN_SAMPLES = 4096, (8, 256, 64), 64
# tasks of the profiled runs that read the card's busy time per task, by bundle
# size (bundle 1 launches ~130 kernels a task: its trace is kept short); they
# run last, since launches stay slower for a while after the profiler stops
TIER_PROFILED = {1: 512, 256: TIER_TASKS}
# the trainer phase: full-width qwen2-1.5b at global batch 2 in 1 microbatch
TRAINER_ARCH, TRAINER_BATCH = "qwen2-1.5b", 2
# the reliability phase: the reference's CI sizes (benchmarks/kill_resume.py,
# benchmarks/real_federation.py)
KILL_RESUME_TASKS = 3000
FED_SHARDS, FED_TASKS, FED_BODY_S, FED_CEILING = 2, 600, 0.001, 100.0
# per task against bundle, f32: a bundle broadcasts the shared weight, so its
# products may sum in another order than one task's (the reference's own
# per-task-vs-bundle test misses rtol 1e-5 by that: 8.3e-5 relative)
TIER_TOL = dict(rtol=1e-4, atol=1e-5)
# the examples phase: the reference's default sizes, and moldyn once more at
# the paper's 244 molecules (1 + 244 x 20 = 4,881 tasks); card against CPU at
# f32 1e-5, the least-squares fit at the test's rtol 1e-4 (tests/test_torch_examples.py)
QUICKSTART_SHAPE = dict(B=1, Hq=4, Hkv=2, S=128, D=64)            # examples/quickstart.py:90-94
QUICKSTART_WINDOW = 64
MOLDYN_PAPER_MOLECULES = 244
EXAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
# deepseek-v2-236b cut to 1 dense + 1 MoE layer at full width: one forward
# and backward at seq 4096 (train_4k's), batch 1, f32 parameters and grads
MEMORY_ARCH, MEMORY_BATCH = "deepseek-v2-236b", 1
# the tooling phases: compression at qwen2-1.5b's gradient shapes, 3 steps a scheme
COMPRESSION_ARCH, COMPRESSION_STEPS, TOPK_FRAC = "qwen2-1.5b", 3, 0.01
# the dry run's cells: full width on the 16 x 16 fake world, one process each
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
                ("qwen2-1.5b", "decode_32k"), ("falcon-mamba-7b", "prefill_32k"),
                ("granite-moe-3b-a800m", "prefill_32k"))
DRYRUN_TIMEOUT_S = 400
# tests/test_kernels.py's tolerances
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}                 # flash attention, RG-LRU scan
MAMBA_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


def log(phase: str, **nums):
    print(json.dumps({"phase": phase, **nums}), flush=True)


def cuda_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wrappers() -> dict:
    from repro_torch.kernels import ops
    return {name: getattr(ops, name) for name in KERNELS}


def check(kernel: str, out, exp, tol: float, **case) -> float:
    """Max abs error of `out` against `exp`; raises past rtol = atol = tol."""
    err = (out.float() - exp.float()).abs().max().item()
    log(f"{kernel}_vs_plain", **case, max_abs_err=err, tol=tol)
    if not torch.allclose(out.float(), exp.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{kernel} disagrees with its plain version: {case}")
    return err


def attn_inputs(gen, B, Hq, Hkv, S, D, dtype, layout="bshd"):
    """q (B,Hq,S,D), k and v (B,Hkv,S,D).  With layout "bshd" they are the
    strided views the main path hands the kernel: (B,S,H,D) projections
    seen through transpose(1, 2), as models/attention.py does.  With "bhsd"
    they are contiguous."""
    def mk(h):
        if layout == "bshd":
            return torch.randn(B, S, h, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        return torch.randn(B, h, S, D, generator=gen, device="cuda").to(dtype)
    return mk(Hq), mk(Hkv), mk(Hkv)


def mamba_inputs(gen, B, S, D, N, dtype, dt_rank=8):
    """u, dt (B,S,D), A (D,N) f32, and Bm, Cm as the main path gives them:
    slices of one (B, S, dt_rank + 2N) projection (row stride dt_rank + 2N)."""
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    u = rn(B, S, D).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, D)).to(dtype)
    A = -torch.exp(rn(D, N) * 0.5)
    proj = rn(B, S, dt_rank + 2 * N).to(dtype)
    return u, dt, A, proj[..., dt_rank:dt_rank + N], proj[..., dt_rank + N:]


@contextlib.contextmanager
def routing_log():
    """Record every MoE routing while the block runs: each call of the
    port's slot helper appends its (gate_idx, keep), copied to the CPU."""
    from repro_torch.models import moe
    calls, slots = [], moe.slots

    def recording(gate_idx, n_experts, c):
        slot, keep = slots(gate_idx, n_experts, c)
        calls.append((gate_idx.cpu(), keep.cpu()))
        return slot, keep

    moe.slots = recording
    try:
        yield calls
    finally:
        moe.slots = slots


def routing_differs(a, b) -> int:
    """(token, k) routing choices that differ between two runs' logs."""
    if [g.shape for g, _ in a] != [g.shape for g, _ in b]:
        raise AssertionError("the two runs routed different groups")
    return sum(int((ga != gb).sum()) for (ga, _), (gb, _) in zip(a, b))


def rglru_inputs(gen, B, S, W, dtype):
    """a in (0.5, 1), b normal, h0 normal f32."""
    a = (0.5 + 0.499 * torch.rand(B, S, W, generator=gen, device="cuda")).to(dtype)
    b = torch.randn(B, S, W, generator=gen, device="cuda").to(dtype)
    return a, b, torch.randn(B, W, generator=gen, device="cuda")


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    seconds = time.perf_counter() - t0
    root = Path(__file__).resolve().parent
    for name, lib in libs.items():
        # ptxas's registers, spills and shared memory for each kernel instance
        report = [ln.split(":", 1)[-1].strip()
                  for ln in lib.with_suffix(".log").read_text().splitlines()
                  if "Compiling entry function" in ln or "Used" in ln or "spill" in ln]
        log("build", source=name, seconds=seconds, library=str(lib.relative_to(root)),
            ptxas=report)


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_flash_vs_plain(gen) -> float:
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import ref_attention
    serve_shape, local_shape = tuple(SERVE_SHAPE.values()), tuple(LOCAL_SHAPE.values())
    granite_shape = tuple(GRANITE_SHAPE.values())
    masks = [(True, 0), (True, 64), (False, 0)]
    cases = [(shape, "bshd", m) for shape in [
        (1, 1, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 32),
        (2, 2, 2, 192, 64),                        # tests/test_kernels.py:21-28
        (2, 4, 2, 100, 16), (2, 4, 2, 1000, 64),  # ragged lengths
        (2, 6, 2, 1000, 64),                       # GQA ratio 3, ragged
        (2, 16, 1, 300, 256),                      # head_dim 256, MQA
        serve_shape, granite_shape] for m in masks]
    cases += [(shape, "bhsd", m) for shape in (serve_shape, granite_shape)
              for m in masks]                                    # and contiguous
    cases += [((1, 16, 1, 2100, 256), "bshd", (True, LOCAL_WINDOW)),   # past one window
              (local_shape, "bshd", (True, LOCAL_WINDOW))]             # recurrentgemma-9b
    cases += [(shape, "bshd", m) for shape in (tuple(STABLELM_SHAPE.values()),
                                               (2, 4, 2, 1000, 160))   # head_dim 160, ragged
              for m in masks]
    cases += [(tuple(GEMMA3_SHAPE.values()), "bshd", (True, GEMMA3_WINDOW)),  # window < S
              (tuple(WHISPER_ENC_SHAPE.values()), "bshd", (False, 0)),      # bidirectional
              (tuple(QWEN2VL_SHAPE.values()), "bshd", (True, 0))]           # GQA ratio 7
    worst = 0.0
    for (B, Hq, Hkv, S, D), layout, (causal, window) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(gen, B, Hq, Hkv, S, D, dtype, layout)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            exp = ref_attention(q, k, v, causal=causal, window=window)
            worst = max(worst, check("flash", out, exp, TOL[dtype], shape=[B, Hq, Hkv, S, D],
                                     layout=layout, causal=causal, window=window,
                                     dtype=str(dtype)))
    return worst


def phase_mamba_vs_plain(gen) -> float:
    from repro_torch.kernels.ops import mamba_scan
    from repro_torch.kernels.ref import ref_selective_scan
    shapes = [(1, 32, 64, 8), (2, 64, 128, 16), (1, 96, 64, 8),   # tests/test_kernels.py:105-109
              (2, 100, 200, 16), (1, 33, 130, 8),                   # ragged S and D
              (2, 1, 3, 16), (1, 17, 70, 8)]                        # one step; D below a lane group
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, D, N in shapes + [tuple(MAMBA_SHAPE.values())]:
            serving = (B, S, D, N) == tuple(MAMBA_SHAPE.values())
            u, dt, A, Bm, Cm = mamba_inputs(gen, B, S, D, N, dtype,
                                            MAMBA_DT_RANK if serving else 8)
            # the main path starts from a zero state; the other cases carry one in
            h0 = None if serving else torch.randn(B, D, N, generator=gen, device="cuda")
            y, h = mamba_scan(u, dt, A, Bm, Cm, h0)
            torch.cuda.synchronize()
            exp_y, exp_h = ref_selective_scan(u, dt, A, Bm, Cm, h0)
            case = dict(shape=[B, S, D, N], dtype=str(dtype), b_row_stride=Bm.stride(1))
            worst = max(worst, check("mamba_scan", y, exp_y, MAMBA_TOL[dtype], output="y", **case),
                        check("mamba_scan", h, exp_h, MAMBA_TOL[dtype], output="h_fin", **case))
    # the decode/prefill contract: a split with the state carried equals one call
    u, dt, A, Bm, Cm = mamba_inputs(gen, 2, 64, 96, 16, torch.float32)
    y, h = mamba_scan(u, dt, A, Bm, Cm)
    y1, h1 = mamba_scan(u[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32])
    y2, h2 = mamba_scan(u[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], h1)
    torch.cuda.synchronize()
    check("mamba_scan", torch.cat([y1, y2], 1), y, 1e-5, output="y", case="state carried")
    check("mamba_scan", h2, h, 1e-5, output="h_fin", case="state carried")
    return worst


def phase_rglru_vs_plain(gen) -> float:
    from repro_torch.kernels.ops import rglru_scan
    from repro_torch.kernels.ref import ref_linear_scan
    shapes = [(1, 64, 128), (2, 128, 256), (2, 96, 128),    # tests/test_kernels.py:66-70
              (2, 100, 200), (1, 17, 4096),                 # ragged S and W
              tuple(RGLRU_SHAPE.values())]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, W in shapes:
            a, b, h0 = rglru_inputs(gen, B, S, W, dtype)
            y, h = rglru_scan(a, b, h0)
            torch.cuda.synchronize()
            exp_y, exp_h = ref_linear_scan(a, b, h0)
            case = dict(shape=[B, S, W], dtype=str(dtype))
            worst = max(worst, check("rglru_scan", y, exp_y, TOL[dtype], output="hs", **case),
                        check("rglru_scan", h, exp_h, TOL[dtype], output="h_fin", **case))
    return worst


# ---------------------------------------------------------------------------
# 3. small models: kernel path on the card against plain path on the CPU
# ---------------------------------------------------------------------------

def phase_small_model(arch, seed):
    """Reduced `arch` in f32 with 2 repeats of each layer group: the kernel
    path on the card against the plain path on the CPU, same weights and
    prompts.  For a MoE arch, the routing choices of the two prefills are
    compared and their differences counted (a near-tie between the K-th
    and (K+1)-th expert, broken otherwise on the card, would show there)."""
    from repro_torch import serve
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_tree, tree_map
    cfg = registry.smoke_config(arch)
    cfg = dataclasses.replace(cfg, blocks=tuple((p, 2) for p, _ in cfg.blocks))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = init_tree(T.build_descriptors(cfg), gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 96), generator=gen)
    enc = torch.randn((2, cfg.enc_frames, cfg.d_model), generator=gen) if cfg.enc_dec else None
    run = {}
    for dev, use_pallas in (("cpu", False), ("cuda", True)):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        p = tree_map(lambda t: t.to(dev), params)
        e = None if enc is None else enc.to(dev)
        with routing_log() as routes:
            logits, _ = T.prefill(c, p, prompts.to(dev), e)
        res = serve.serve(c, batch=2, prompt_len=96, new_tokens=8, device=dev,
                          params=p, prompts=prompts.to(dev), enc_feats=e)
        run[dev] = (logits.cpu(), res["tokens"].cpu(), routes)
    err = (run["cpu"][0] - run["cuda"][0]).abs().max().item()
    same = bool(torch.equal(run["cpu"][1], run["cuda"][1]))
    moe = {}
    if cfg.moe is not None:
        routes = run["cpu"][2]
        moe = {"routing_choices": sum(g.numel() for g, _ in routes),
               "routing_choices_differ": routing_differs(routes, run["cuda"][2]),
               "dropped": sum(int((~k).sum()) for _, k in routes)}
    log("small_model", arch=arch, max_abs_err=err, tol=1e-4, greedy_tokens_equal=same, **moe)
    if err > 1e-4 or not same:
        raise AssertionError(f"{arch}: the kernel path on the card disagrees with the "
                             f"plain path on the CPU")


# ---------------------------------------------------------------------------
# 3a/3b. training
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 8, 4, 6


def phase_train_small(arch, seed):
    """One f32 train step of reduced `arch` (2 repeats per layer group, 2
    microbatches) on the card and on the CPU, from the same weights and
    batch; held to 1e-4, the CPU tests' f32 tolerance."""
    from repro_torch import train as tr
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    cfg = registry.smoke_config(arch)
    cfg = dataclasses.replace(cfg, blocks=tuple((p, 2) for p, _ in cfg.blocks))
    params = tr.init_params(cfg, seed, "cpu")
    batch = SyntheticLM(cfg, DataConfig(seed=seed, global_batch=4, seq_len=64)).global_batch(0)
    hp = adamw.Hyper(warmup=2, total_steps=1, microbatches=2)
    run = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with routing_log() as routes:
            p, _, m = make_train_step(cfg, hp)(p, adamw.init(p), b, 0)
        run[dev] = (m["loss"].item(), m["grad_norm"].item(),
                    [t.cpu() for t in tree_leaves(p)], m["aux"].item(), routes)
    errs = {"loss": abs(run["cpu"][0] - run["cuda"][0]),
            "grad_norm": abs(run["cpu"][1] - run["cuda"][1]),
            "params": max((a - b).abs().max().item()
                          for a, b in zip(run["cpu"][2], run["cuda"][2]))}
    moe = {}
    if cfg.moe is not None:
        moe = {"aux": run["cuda"][3],
               "routing_choices_differ": routing_differs(run["cpu"][4], run["cuda"][4])}
    log("train_small", arch=arch, loss=run["cuda"][0], grad_norm=run["cuda"][1],
        max_abs_err=errs, tol=1e-4, **moe)
    if not all(math.isfinite(run[d][0]) for d in run) or max(errs.values()) > 1e-4:
        raise AssertionError(f"{arch}: a train step on the card disagrees with the CPU")


def f32_loss(cfg, params, batch):
    """The loss of `batch` with f32 compute, microbatch by microbatch as the
    train step takes it, without gradients."""
    from repro_torch.models import transformer as T
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    micro = [{k: v.reshape(TRAIN_MICRO, -1, v.shape[1])[i] for k, v in batch.items()}
             for i in range(TRAIN_MICRO)]
    with torch.no_grad():
        losses = [T.forward_train(f32, params, mb)[0] for mb in micro]
    return torch.stack(losses).mean().item()


def phase_train(seed):
    """Full-width qwen2-1.5b trains for TRAIN_STEPS steps in bf16 compute
    on an f32 master copy; returns the summary."""
    from repro_torch import train as tr
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    cfg = dataclasses.replace(registry.get_config("qwen2-1.5b"), use_pallas=False)
    params = tr.init_params(cfg, seed, "cuda")
    first = SyntheticLM(cfg, DataConfig(seed=seed, global_batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ)).global_batch(0)
    loss_f32 = f32_loss(cfg, params, {k: torch.from_numpy(v).cuda() for k, v in first.items()})
    res = tr.train(cfg, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                   microbatches=TRAIN_MICRO, seed=seed, device="cuda", params=params,
                   log=lambda row: log("train_step", **row))
    del params
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in res["steps"]]
    norms = [r["grad_norm"] for r in res["steps"]]
    summary = {k: v for k, v in res.items() if k != "steps"}
    log("train", arch=cfg.name, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
        microbatches=TRAIN_MICRO, steps=TRAIN_STEPS, n_params=cfg.param_count(),
        model_flops_per_step=tr.model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ),
        first_loss_bf16=losses[0], first_loss_f32=loss_f32, last_loss=losses[-1],
        bf16_vs_f32_tol=5e-2, **summary)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad_norm: {losses}, {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if abs(losses[0] - loss_f32) > 5e-2:
        raise AssertionError(f"first-step loss in bf16 {losses[0]} is not within 5e-2 "
                             f"of the f32 loss {loss_f32}")
    if not summary["peak_mem_bytes"] < 80e9:
        raise AssertionError(f"peak memory {summary['peak_mem_bytes']} bytes")
    return summary


# ---------------------------------------------------------------------------
# 4. serve at full width
# ---------------------------------------------------------------------------

def draw(cfg, seed, prompt):
    """Weights from `seed`, stored in the compute dtype (but the leaves read
    in f32), B prompts of `prompt` + 1 tokens, and for an encoder-decoder
    its (B, enc_frames, d_model) f32 frame embeddings (else None)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.params import init_tree
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    p = init_tree(T.build_descriptors(cfg), g, "cuda", dtype=compute_dtype(cfg))
    toks = torch.randint(0, cfg.vocab, (BATCH, prompt + 1), generator=g, device="cuda")
    enc = (torch.randn((BATCH, cfg.enc_frames, cfg.d_model), generator=g, device="cuda")
           if cfg.enc_dec else None)
    return p, toks, enc


def drop_free(cfg):
    """`cfg` with capacity_factor = n_experts / top_k: every expert has at
    least g slots in a group of g tokens, so no assignment drops."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def decode_vs_prefill(cfg, params, toks, enc, seed, tol, hold=True, **note):
    """Decode token P after a P-token prefill == the last position of a
    (P+1)-token prefill (toks holds P + 1 tokens; `enc` the encoder's
    frames, or None), with argmax equal; raises otherwise if `hold`.
    Returns the two logits (decode's, the longer prefill's last), f32.

    For a MoE arch the (P+1)-token prefill's routing is logged: the
    (token, k) assignments it dropped in all, and those of its last
    position (a one-token decode step routes a group of one and drops
    none, so only a drop-free capacity makes the two the same function)."""
    from repro_torch import serve
    from repro_torch.models import transformer as T
    P = toks.shape[1] - 1
    with torch.no_grad():
        logits_p, caches = T.prefill(cfg, params, toks[:, :P], enc)
        caches = serve.grow_caches(caches, P, P + 1)
        logits_d, _ = T.decode_step(cfg, params, caches, toks[:, P:], P)
        del caches
        with routing_log() as routes:
            logits_f, _ = T.prefill(cfg, params, toks, enc)
    if not (torch.isfinite(logits_p).all() and torch.isfinite(logits_d).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    diff = (logits_d - logits_f).abs()
    same = bool(torch.equal(logits_d.argmax(-1), logits_f.argmax(-1)))
    if cfg.moe is not None:
        # each layer routes (P+1) / g groups in turn; the last holds position P
        g = min(cfg.moe.group_size, P + 1)
        while (P + 1) % g:
            g -= 1
        last = routes[(P + 1) // g - 1::(P + 1) // g]
        note.update(capacity_factor=cfg.moe.capacity_factor,
                    dropped=sum(int((~k).sum()) for _, k in routes),
                    dropped_at_last_position=sum(int((~k[:, :, -1]).sum()) for _, k in last),
                    assignments_at_last_position=sum(k[:, :, -1].numel() for _, k in last))
    log("decode_vs_prefill", arch=cfg.name, compute_dtype=cfg.compute_dtype, seed=seed,
        n_layers=cfg.n_layers, prompt_len=P, max_abs_err=diff.max().item(),
        mean_abs_err=diff.mean().item(), tol=tol, held=hold,
        logits_abs_max=logits_f.abs().max().item(), argmax_equal=same, **note)
    if hold and (not torch.allclose(logits_d, logits_f, rtol=tol, atol=tol) or not same
                 or note.get("dropped")):
        raise AssertionError(f"{cfg.name}: decode disagrees with prefill "
                             f"({cfg.compute_dtype}, seed {seed})")
    return logits_d.float(), logits_f.float()


def check_decode(cfg, params, toks, enc, seed, tol, hold=True, **note):
    """`decode_vs_prefill`, held (if `hold`) on the drop-free capacity for a
    MoE arch and, in bf16, logged without a verdict at the published
    capacity.  Returns the logits of the first run."""
    if cfg.moe is None:
        return decode_vs_prefill(cfg, params, toks, enc, seed, tol, hold, **note)
    out = decode_vs_prefill(drop_free(cfg), params, toks, enc, seed, tol, hold,
                            capacity="drop-free (n_experts / top_k): held", **note)
    if cfg.compute_dtype == "bfloat16":
        decode_vs_prefill(cfg, params, toks, enc, seed, tol, hold=False,
                          capacity="published: logged, not held (drops differ)", **note)
    return out


def bf16_vs_f32(arch, bf16, f32_logits, tol=5e-2):
    """The bf16 decode's and (P+1)-token prefill's logits against the f32
    model's prefill from the same seed (the same weights before rounding):
    decode may be no farther from it than prefill is, by more than `tol`.
    Both bf16 paths round; a decode fault would move only decode's."""
    err_d, err_p = ((x - f32_logits).abs().max().item() for x in bf16)
    log("bf16_vs_f32", arch=arch, decode_max_abs_err=err_d, prefill_max_abs_err=err_p,
        tol=tol, held=True)
    if not err_d <= err_p + tol:
        raise AssertionError(f"{arch}: bf16 decode is {err_d} from the f32 model, "
                             f"prefill {err_p}")


def phase_serve(arch, seed) -> dict:
    """Serve full-width `arch` in bf16; returns each kernel's launches in
    the served run.

    Decode vs prefill at full width and full depth (deepseek-v2-236b: the
    served cut): bf16 is held to 5e-2, the repo's own decode-vs-prefill
    tolerance (tests/test_decode_consistency.py:49), since bf16 rounding
    of the residual stream compounds over the layers (stablelm-12b's is
    logged there and held by `bf16_vs_f32`, see BF16_HELD_AGAINST_F32); f32
    to 1e-4, the CPU tests' model tolerance.  Where the f32 check runs at
    full depth, `bf16_vs_f32` also holds the bf16 decode against the f32
    model.  qwen2-1.5b's bf16 check also runs on a second seed.  The bf16
    weights are freed before the f32 copy is drawn; the f32 checks of
    deepseek-v2-236b (1 dense + 1 MoE layer, 21.4 GB of f32 weights) and
    gemma3-27b (8 of its 62 layers, about 19 GB; 108 GB at full depth)
    run at 1 repeat per layer group; gemma3-27b's runs again at a
    1500-token prompt, past its 1024-token window and not a multiple of
    it, where the port's ring cache departs from the reference's
    (models/attention.py).
    """
    from repro_torch import serve
    from repro_torch.configs import registry
    from repro_torch.device import device_memory
    cap = MAX_REPEATS.get(arch)
    cfg = serve.served_config(arch, cap, device_memory(torch.device("cuda")))
    full = registry.get_config(arch)
    reduced = {} if cap is None else {"reduced": {
        "blocks": f"repeats {[r for _, r in full.blocks]} -> {[r for _, r in cfg.blocks]}",
        "n_layers": f"{full.n_layers} -> {cfg.n_layers}", "widths": "unchanged"}}
    prompt = serve.default_prompt_len(cfg)
    params, prompts, enc = draw(cfg, seed, prompt)
    kw = dict(batch=BATCH, prompt_len=prompt, device="cuda", params=params,
              prompts=prompts[:, :prompt], enc_feats=enc)
    serve.serve(cfg, new_tokens=2, **kw)     # warm-up: library loading and first-call set-up

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    res = serve.serve(cfg, new_tokens=NEW, **kw)
    launches = {name: w.launches for name, w in ws.items()}
    toks = res["tokens"]
    enc_note = {"enc_frames": cfg.enc_frames} if cfg.enc_dec else {}
    log("serve", arch=arch, batch=BATCH, prompt_len=prompt, **enc_note, new_tokens=NEW,
        prefill_ms=res["prefill_ms"], decode_ms_per_token=res["decode_ms_per_token"],
        tokens_per_s=res["tokens_per_s"], peak_mem_bytes=res["peak_mem_bytes"],
        launches=launches, n_layers=cfg.n_layers, n_params=cfg.param_count(), **reduced)
    if launches != SERVE_LAUNCHES[arch]:
        raise AssertionError(f"{arch}: launches in one prefill {launches}, "
                             f"want {SERVE_LAUNCHES[arch]}")
    if toks.shape != (BATCH, NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"{arch}: bad generated tokens: shape {tuple(toks.shape)}")
    if not res["peak_mem_bytes"] < 80e9:
        raise AssertionError(f"{arch}: peak memory {res['peak_mem_bytes']} bytes")

    noisy = BF16_HELD_AGAINST_F32.get(arch)
    bf16 = check_decode(cfg, params, prompts, enc, seed, 5e-2, hold=noisy is None,
                        **({"not_held": noisy} if noisy else {}))
    del params, prompts, enc, kw
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    f32_note = {}
    if arch in F32_CUT:
        f32 = registry.cut_depth(f32, 1)
        f32_note = {"reduced": f"f32 at 1 repeat per layer group ({F32_CUT[arch]}) to fit the card"}
    checks = [(cfg, seed + 1, 5e-2, prompt, {})] if arch == "qwen2-1.5b" else []
    checks.append((f32, seed, 1e-4, prompt, f32_note))
    if arch == "gemma3-27b":
        checks.append((f32, seed, 1e-4, GEMMA3_RAGGED_PROMPT,
                       {**f32_note, "ring": "prompt 1500 = 1024 + 476: held against the "
                                            "(P+1)-token prefill"}))
    for c, s, tol, prompt_c, note in checks:
        p, t, e = draw(c, s, prompt_c)
        logits = check_decode(c, p, t, e, s, tol, **note)
        del p, t, e
        torch.cuda.empty_cache()
        if c is f32 and prompt_c == prompt and arch not in F32_CUT:
            bf16_vs_f32(arch, bf16, logits[1])
    return launches


# ---------------------------------------------------------------------------
# 4a. the device tier: the paper's scheduler on the card
# ---------------------------------------------------------------------------

def tier_outputs(row) -> torch.Tensor:
    """A sweep row's outputs in task order; every path of the pool, bundle or
    singleton, brings them back to the host."""
    if any(o.device.type != "cpu" for o in row["outputs"]):
        raise AssertionError(f"device tier, bundle {row['bundle']}: outputs left on the card")
    return torch.stack(row["outputs"])


def hold_tier(what, got, exp) -> float:
    """Max abs error of `got` against `exp`; raises past `TIER_TOL`."""
    err = (got - exp).abs().max().item()
    if not torch.allclose(got, exp, **TIER_TOL):
        raise AssertionError(f"device tier: {what} disagrees, max abs err {err}")
    return err


def card_busy_s_per_task(bench, args, bundle) -> float:
    """The card's busy seconds per task (kernels and copies, from
    `torch.profiler`) over a run of `args` at `bundle`, warm-up included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = bench.measure(bench.small_task, args, bundle, "cuda", reps=1)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    return busy / (r["tasks_run"] + min(len(args), bench.WARM))


def phase_device_tier(seed):
    """The paper's scheduler driving the card (Workflow/Engine -> Falkon ->
    DeviceExecutorPool), through `repro_torch.benchmarks.device_batching`."""
    from repro_torch.benchmarks import device_batching as bench
    from repro_torch.kernels.ops import attention_task
    from repro_torch.launch.op_cost import DeviceModel, DurationPredictor

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    t0 = time.perf_counter()
    pred = DurationPredictor(DeviceModel(peak_flops=PEAK_F32_FLOPS, mem_bw=PEAK_BYTES))
    sweep = bench.run(TIER_TASKS, "cuda", reps=1, seed=seed, predictor=pred)
    xs, w = bench.make_inputs(TIER_TASKS, seed)     # the sweep's inputs, drawn again
    pick = np.sort(np.random.default_rng(seed).choice(TIER_TASKS, TIER_SAMPLES,
                                                      replace=False))
    on_cpu = torch.stack([bench.small_task(torch.from_numpy(xs[i]), torch.from_numpy(w))
                          for i in pick])
    rows = {}
    for r in sweep["sweep"]:
        b = r["bundle"]
        out = tier_outputs(r)
        fused_expected = 0 if b == 1 else TIER_TASKS
        if r["tasks_run"] != TIER_TASKS or r["fused_tasks"] != fused_expected:
            raise AssertionError(f"device tier, bundle {b}: {r['tasks_run']} tasks run, "
                                 f"{r['fused_tasks']} fused")
        if out.shape != (TIER_TASKS, bench.ROWS) or not torch.isfinite(out).all():
            raise AssertionError(f"device tier, bundle {b}: outputs not finite or shaped "
                                 f"{tuple(out.shape)}")
        err = hold_tier(f"bundle {b} vs per task on the CPU", out[torch.from_numpy(pick)], on_cpu)
        rows[b] = dict(r, host_outputs=out)
        log("device_tier", bundle=b, wall_s=r["wall_s"], tasks_per_s=r["tasks_per_s"],
            device_frac=r["device_frac"], bundles_run=r["bundles_run"],
            fused_tasks=r["fused_tasks"], tasks_run=r["tasks_run"],
            run_s_mean=r["run_s_mean"], max_abs_err_vs_cpu=err, **TIER_TOL)
    top = max(rows)
    args = [[xs[i], w] for i in range(TIER_TASKS)]
    two = bench.measure(bench.small_task, args, top, "cuda", reps=1, dispatchers=2)
    if two["tasks_run"] != TIER_TASKS or two["fused_tasks"] != TIER_TASKS:
        raise AssertionError(f"device tier, two dispatchers: {two['tasks_run']} run, "
                             f"{two['fused_tasks']} fused")
    err = hold_tier("two dispatchers vs one", tier_outputs(two), rows[top]["host_outputs"])
    log("device_tier_two_dispatchers", bundle=top, wall_s=two["wall_s"],
        tasks_per_s=two["tasks_per_s"], device_frac=two["device_frac"],
        bundles_run=two["bundles_run"], max_abs_err_vs_one=err)

    rng = np.random.default_rng(seed + 1)
    qkv = [rng.standard_normal((TIER_ATTN_TASKS, *TIER_ATTN_SHAPE), dtype=np.float32)
           for _ in range(3)]
    attn_args = [[a[i] for a in qkv] for i in range(TIER_ATTN_TASKS)]
    attn = bench.measure(attention_task, attn_args, top, "cuda", reps=1)
    if attn["tasks_run"] != TIER_ATTN_TASKS or attn["fused_tasks"] != TIER_ATTN_TASKS:
        raise AssertionError(f"device tier, attention: {attn['tasks_run']} run, "
                             f"{attn['fused_tasks']} fused")
    out = tier_outputs(attn)
    apick = np.sort(rng.choice(TIER_ATTN_TASKS, TIER_ATTN_SAMPLES, replace=False))
    exp = torch.stack([attention_task(*[torch.from_numpy(a[i]) for a in qkv]) for i in apick])
    if not torch.isfinite(out).all():
        raise AssertionError("device tier, attention: outputs not finite")
    err = hold_tier("attention bundle vs per task on the CPU", out[torch.from_numpy(apick)], exp)
    log("device_tier_attention", tasks=TIER_ATTN_TASKS, shape=TIER_ATTN_SHAPE, bundle=top,
        wall_s=attn["wall_s"], tasks_per_s=attn["tasks_per_s"],
        device_frac=attn["device_frac"], bundles_run=attn["bundles_run"],
        run_s_mean=attn["run_s_mean"], max_abs_err_vs_cpu=err, **TIER_TOL)
    del qkv, attn_args, attn, out

    cost = pred.predict_cost(bench.small_task, args[0])
    log("device_tier_predictor", predicted_task_s=sweep["predicted_task_s"],
        flops=cost.flops, bytes=cost.bytes,
        measured_run_s_mean={b: rows[b]["run_s_mean"] for b in (1, top)})
    log("device_tier_targets", speedup=sweep["speedup_largest_vs_single"],
        speedup_target=bench.SPEEDUP_TARGET, best_bundle=sweep["best_bundle"],
        best_device_frac=sweep["best_bundled_device_frac"],
        device_frac_target=bench.DEVICE_FRAC_TARGET, held=sweep["targets_held"])
    for b, n in TIER_PROFILED.items():
        busy = card_busy_s_per_task(bench, args[:n], b)
        log("device_tier_card", bundle=b, profiled_tasks=n, card_busy_s_per_task=busy,
            card_busy_share=busy * rows[b]["tasks_per_s"])
    launched = {name: w.launches for name, w in ws.items()}
    if any(launched.values()):
        raise AssertionError(f"the device tier launched a kernel: {launched}")
    log("device_tier_done", launches=launched, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 4b. trainer: the engine-driven Trainer with checkpoint, faults and resume
# ---------------------------------------------------------------------------

def state_sums(state) -> dict:
    """A float64 sum of each leaf of a state tree, computed on its device."""
    from repro_torch.checkpoint.checkpointer import _flatten
    return {k: torch.sum(v, dtype=torch.float64).item() for k, v in _flatten(state).items()}


def logged_checkpointer(ckpt, records: list):
    """`ckpt` (a Checkpointer) whose save and restore append a record:
    step, host seconds (after the device finished), bytes and the state's
    per-leaf checksums (taken before a save, after a restore)."""
    from repro_torch.checkpoint.checkpointer import _flatten
    save, restore = ckpt.save, ckpt.restore

    def nbytes_of(state):
        return sum(v.numel() * v.element_size() for v in _flatten(state).values())

    def logged_save(step, state):
        sums = state_sums(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = save(step, state)
        seconds = time.perf_counter() - t0
        records.append(dict(op="save", step=step, seconds=seconds, bytes=nbytes_of(state),
                            sums=sums))
        log("trainer_checkpoint", step=step, seconds=seconds, bytes=nbytes_of(state),
            gb_per_s=nbytes_of(state) / seconds / 1e9, leaves=len(sums), checksums=sums)
        return refs

    def logged_restore(template, step=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, got = restore(template, step)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        records.append(dict(op="restore", step=got, seconds=seconds, bytes=nbytes_of(state),
                            sums=state_sums(state)))
        log("trainer_restore", step=got, seconds=seconds, bytes=nbytes_of(state),
            gb_per_s=nbytes_of(state) / seconds / 1e9)
        return state, got

    ckpt.save, ckpt.restore = logged_save, logged_restore
    return ckpt


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def phase_trainer(seed):
    """Full-width qwen2-1.5b through the engine-driven Trainer: run A takes
    steps 0-2 with two injected step faults and checkpoints at step 2; run B,
    a fresh Trainer on the same workdir, resumes there and takes steps 2-3.
    Then a bare `train()` at the same batch, for what the engine costs."""
    from repro_torch import train as tr
    from repro_torch.configs import registry
    from repro_torch.core import FaultInjector
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(TRAINER_ARCH), use_pallas=False)
    hp = adamw.Hyper(lr=3e-4, warmup=2, total_steps=4, microbatches=1)
    dcfg = DataConfig(seed=seed, global_batch=TRAINER_BATCH, seq_len=TRAIN_SEQ)
    workdir = Path(__file__).resolve().parent / "build" / "trainer"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    # the f32 parameters and AdamW's two f32 moments: one checkpoint
    state_bytes = 3 * 4 * cfg.param_count()
    free = shutil.disk_usage(workdir).free
    log("trainer_disk", workdir=str(workdir), free_bytes=free, state_bytes=state_bytes)
    if free < 1.25 * state_bytes:
        raise AssertionError(f"trainer: {free} bytes free under {workdir}, one checkpoint "
                             f"takes {state_bytes}")
    records = []
    torch.cuda.reset_peak_memory_stats()
    try:
        a = Trainer(cfg, hp, dcfg, str(workdir),
                    TrainerConfig(total_steps=3, ckpt_every=2, eval_every=2, seed=seed),
                    fault_injector=FaultInjector(seed=0).fail_first_n("train_step", 2),
                    device="cuda")
        logged_checkpointer(a.ckpt, records)
        hist_a = a.fit()
        rows_a = [r for r in hist_a if "loss" in r]
        for r in hist_a:
            log("trainer_a", **r)
        retries = len(a.vdc.failures())
        stats_a, setup_a, run_a = a.engine_stats, a.setup_s, a.run_s
        del a
        free_card()

        b = Trainer(cfg, hp, dcfg, str(workdir), TrainerConfig(total_steps=4, ckpt_every=0,
                                                               seed=seed), device="cuda")
        logged_checkpointer(b.ckpt, records)
        hist_b = b.fit()
        rows_b = [r for r in hist_b if "loss" in r]
        for r in hist_b:
            log("trainer_b", **r)
        stats_b, setup_b, run_b = b.engine_stats, b.setup_s, b.run_s
        del b
        free_card()
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    bare = tr.train(cfg, steps=3, seq_len=TRAIN_SEQ, batch=TRAINER_BATCH, microbatches=1,
                    seed=seed, device="cuda", log=lambda row: log("trainer_bare_step", **row))
    free_card()

    saves = [r for r in records if r["op"] == "save"]
    restores = [r for r in records if r["op"] == "restore"]
    steps_a, steps_b = [r["step"] for r in rows_a], [r["step"] for r in rows_b]
    loss_a2 = next(r["loss"] for r in rows_a if r["step"] == 2)
    loss_b2 = rows_b[0]["loss"] if rows_b else float("nan")
    engine_ms = statistics.median(r["step_time"] for r in rows_a + rows_b) * 1e3
    log("trainer", arch=cfg.name, seq_len=TRAIN_SEQ, batch=TRAINER_BATCH, microbatches=1,
        steps_a=steps_a, steps_b=steps_b, retries=retries, engine_stats_a=stats_a,
        engine_stats_b=stats_b, checkpoints=[r["step"] for r in saves],
        checkpoint_s=[r["seconds"] for r in saves], restore_s=[r["seconds"] for r in restores],
        state_bytes=state_bytes,
        checkpoint_gb_per_s=[r["bytes"] / r["seconds"] / 1e9 for r in saves],
        restore_gb_per_s=[r["bytes"] / r["seconds"] / 1e9 for r in restores],
        loss_a_step2=loss_a2, loss_b_step2=loss_b2,
        rel_diff=abs(loss_b2 - loss_a2) / abs(loss_a2),
        setup_s_a=setup_a, run_s_a=run_a, setup_s_b=setup_b, run_s_b=run_b,
        step_ms_engine_median=engine_ms,
        wall_ms_per_step_b=run_b / max(1, len(steps_b)) * 1e3,
        step_ms_bare_median=bare["step_ms"], peak_mem_bytes=peak,
        seconds=time.perf_counter() - t_phase)
    if steps_a != [0, 1, 2] or steps_b != [2, 3]:
        raise AssertionError(f"trainer: run A took steps {steps_a}, run B {steps_b}")
    if stats_a["failed"] or stats_b["failed"] or retries != 2:
        raise AssertionError(f"trainer: failed tasks {stats_a['failed']}, {stats_b['failed']}; "
                             f"{retries} retried attempts, 2 injected")
    if [r["step"] for r in saves] != [2] or [r["step"] for r in restores] != [2]:
        raise AssertionError(f"trainer: saved {saves}, restored {restores}")
    if restores[0]["sums"] != saves[0]["sums"]:
        bad = [k for k in saves[0]["sums"] if restores[0]["sums"].get(k) != saves[0]["sums"][k]]
        raise AssertionError(f"trainer: restored checksums differ at {bad}")
    losses = [r["loss"] for r in rows_a + rows_b] + [r["eval_loss"] for r in hist_a
                                                   if "eval_loss" in r]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"trainer: non-finite losses {losses}")
    if not abs(loss_b2 - loss_a2) <= 1e-4 * abs(loss_a2):
        raise AssertionError(f"trainer: the resumed step-2 loss {loss_b2} is not within 1e-4 "
                             f"of run A's {loss_a2}")
    if not peak < 80e9:
        raise AssertionError(f"trainer: peak memory {peak} bytes")


# ---------------------------------------------------------------------------
# 4c. reliability: kill-and-resume and the process federation, CUDA live
# ---------------------------------------------------------------------------

def fed_values(fed, n):
    """The real_federation workload: `n` sleep tasks keyed t#i, whose
    bodies sleep (and return) 1, 2 or 3 ms."""
    from repro_torch.core.procfed import body_sleep
    futs = [fed.submit("t", body_sleep, [FED_BODY_S * (1 + i % 3)],
                       duration=FED_BODY_S * (1 + i % 3), key=f"t#{i}") for i in range(n)]
    fed.run()
    return futs


def phase_reliability(seed):
    """With CUDA initialised here: the port's kill_resume benchmark at the
    reference's CI size, and a 2-shard ProcessFederation (spawned shards)
    against an in-process FederatedEngine under SimClock."""
    from repro_torch.benchmarks import kill_resume as kr
    from repro_torch.core import (DRPConfig, FalkonConfig, FalkonProvider, FalkonService,
                                  FederatedEngine, ProcessFederation, ShardSpec, SimClock)

    if not torch.cuda.is_initialized():
        raise AssertionError("reliability: CUDA is not initialised in the parent")
    t0 = time.perf_counter()
    workdir = Path(__file__).resolve().parent / "build" / "kill_resume"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        payload = kr.measure(KILL_RESUME_TASKS, str(workdir))   # asserts the reference's bounds
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("reliability_kill_resume", **payload)

    clock = SimClock()
    sim = FederatedEngine(FED_SHARDS, clock=clock, steal=False,
                          engine_kwargs={"provenance": "summary"})
    for i, eng in enumerate(sim.shards):
        svc = FalkonService(clock, FalkonConfig(drp=DRPConfig(
            max_executors=2, alloc_latency=1e-4, alloc_chunk=2)))
        eng.add_site(f"falkon{i}", FalkonProvider(svc), capacity=2)
    sim_vals = [f.get() for f in fed_values(sim, FED_TASKS)]
    spec = ShardSpec(executors=2, serialize_dispatch=True, dispatch_overhead=1.0 / FED_CEILING,
                     alloc_latency=1e-4)
    with ProcessFederation(FED_SHARDS, spec, steal=False) as fed:
        fed.wait_ready()
        t1 = time.perf_counter()
        futs = fed_values(fed, FED_TASKS)
        wall = time.perf_counter() - t1
        real_vals = [f.get() if f.done and not f.failed else None for f in futs]
        stats = fed.stats()
    log("reliability_procfed", shards=FED_SHARDS, tasks=FED_TASKS, wall_s=wall,
        tasks_per_s=FED_TASKS / wall, completed=stats["completed"], failed=stats["failed"],
        per_shard_completed=stats["per_shard_completed"],
        sim_per_shard_completed=sim.stats()["per_shard_completed"], sim_makespan=clock.now(),
        seconds=time.perf_counter() - t0)
    if real_vals != sim_vals or stats["completed"] != FED_TASKS or stats["failed"]:
        raise AssertionError("reliability: the process federation's values differ from the "
                             "in-process federation's")
    if stats["per_shard_completed"] != sim.stats()["per_shard_completed"]:
        raise AssertionError("reliability: the two federations placed tasks differently")


# ---------------------------------------------------------------------------
# 4d. vmap_clustering: the reference's clustering benchmark on the card
# ---------------------------------------------------------------------------

def phase_vmap_clustering(seed):
    from repro_torch.benchmarks import vmap_clustering as vc
    t0 = time.perf_counter()
    res = vc.run("cuda", seed)
    fused, single = res["outputs_fused"], res["outputs_per_task"]
    err = hold_tier("vmap_clustering fused vs per task", fused, single)
    log("vmap_clustering", **{k: v for k, v in res.items() if not k.startswith("outputs")},
        max_abs_err=err, seconds=time.perf_counter() - t0, **TIER_TOL)
    if fused.shape != (vc.N_TASKS,) or not torch.isfinite(fused).all():
        raise AssertionError("vmap_clustering: outputs not finite or misshapen")
    vc.check(res)


# ---------------------------------------------------------------------------
# 4d'. the example workflows on the card, and a train step's memory
# ---------------------------------------------------------------------------

def close_all(what, got, want, tol) -> float:
    """Max abs difference of two lists of tensors (or floats); raises past
    `tol`."""
    got = [torch.as_tensor(g).detach().float().cpu() for g in got]
    want = [torch.as_tensor(w).detach().float().cpu() for w in want]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results against {len(want)}")
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite results")
        if not torch.allclose(g, w, **tol):
            raise AssertionError(f"{what}: the card disagrees with the CPU at {tol}")
    return max((float((g - w).abs().max()) for g, w in zip(got, want)), default=0.0)


def timed_example(name, fn, **kw):
    """fn(**kw) on the host's clock, logged with tasks/s (the engines'
    submitted tasks over the wall) and the card's name and power limit."""
    t0 = time.perf_counter()
    out = fn(**kw)
    wall = time.perf_counter() - t0
    stats = out["stats"]        # quickstart's: one per engine
    tasks = (stats["submitted"] if "submitted" in stats
             else sum(v["submitted"] for v in stats.values()))
    log("example", example=name, device=kw.get("device", "cuda"), wall_s=wall, tasks=tasks,
        tasks_per_s=tasks / wall, card=smi_name_and_limit(), **{
            k: v for k, v in kw.items() if k in ("molecules",)})
    return out


def smi_name_and_limit() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_examples(seed):
    """The port's four example workflows on the card, each against the same
    example on the CPU: quickstart (from weights, tokens and q, k, v drawn
    on the card and copied to the CPU; its flash call is the phase's one
    kernel launch), moldyn twice on one workdir (the second run restores
    from the log) and once at the paper's 244 molecules, montage and fmri
    at the reference's default sizes."""
    from repro_torch.configs import registry
    from repro_torch.examples import fmri_workflow, moldyn_workflow, montage_workflow, quickstart
    from repro_torch.kernels.ref import ref_attention
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_tree, tree_map

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    cfg = registry.smoke_config("qwen2-1.5b")
    params = init_tree(T.build_descriptors(cfg), gen.manual_seed(seed), "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device="cuda",
                           dtype=torch.int32)
    s = QUICKSTART_SHAPE
    qkv = [torch.randn(s["B"], h, s["S"], s["D"], generator=gen, device="cuda")
           for h in (s["Hq"], s["Hkv"], s["Hkv"])]
    cpu = lambda t: t.cpu()  # noqa: E731
    host = dict(params=tree_map(cpu, params), tokens=tokens.cpu(), qkv=[t.cpu() for t in qkv])
    card = timed_example("quickstart", quickstart.run, device="cuda",
                         params=tree_map(torch.clone, params), tokens=tokens, qkv=qkv)
    ref = quickstart.run("cpu", **host)
    flash_err = close_all("quickstart flash vs ref_attention", [card["kernel"]["out"]],
                          [ref_attention(*qkv, causal=True, window=QUICKSTART_WINDOW)],
                          dict(rtol=TOL[torch.float32], atol=TOL[torch.float32]))
    close_all("quickstart flash, card vs CPU", [card["kernel"]["out"]], [ref["kernel"]["out"]],
              dict(rtol=TOL[torch.float32], atol=TOL[torch.float32]))
    model_err = close_all("quickstart train step", [card["model"][k] for k in ("loss", "grad_norm")],
                          [ref["model"][k] for k in ("loss", "grad_norm")], EXAMPLE_TOL)
    if card["workflow"]["sum"] != 285 or card["real"]["sum"] != 285:
        raise AssertionError(f"quickstart: sums {card['workflow']['sum']}, {card['real']['sum']}")
    log("example_quickstart", loss=card["model"]["loss"], grad_norm=card["model"]["grad_norm"],
        train_step_max_abs_err=model_err, flash_vs_ref_max_abs_err=flash_err,
        flash_shape=list(s.values()), window=QUICKSTART_WINDOW, stats=card["stats"])

    root = Path(__file__).resolve().parent / "build" / "examples"
    shutil.rmtree(root, ignore_errors=True)
    try:
        first = timed_example("moldyn", moldyn_workflow.run, device="cuda",
                              workdir=str(root / "moldyn"))
        second = timed_example("moldyn_resumed", moldyn_workflow.run, device="cuda",
                               workdir=str(root / "moldyn"))
        host_md = moldyn_workflow.run(device="cpu", workdir=str(root / "moldyn_cpu"))
        paper = timed_example("moldyn_paper", moldyn_workflow.run, device="cuda",
                              molecules=MOLDYN_PAPER_MOLECULES, workdir=str(root / "paper"))
        host_paper = moldyn_workflow.run(MOLDYN_PAPER_MOLECULES, str(root / "paper_cpu"), "cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    md_err = close_all("moldyn", first["energies"], host_md["energies"], EXAMPLE_TOL)
    close_all("moldyn resumed", second["energies"], first["energies"], EXAMPLE_TOL)
    paper_err = close_all("moldyn at 244 molecules", paper["energies"], host_paper["energies"],
                          EXAMPLE_TOL)
    restored = second["stats"]["restored_from_log"]
    log("example_moldyn", energies=first["energies"], max_abs_err=md_err, restored=restored,
        stats=first["stats"], stats_resumed=second["stats"], paper_stats=paper["stats"],
        paper_max_abs_err=paper_err)
    if restored <= 0 or paper["stats"]["submitted"] != 1 + 20 * MOLDYN_PAPER_MOLECULES:
        raise AssertionError(f"moldyn: restored {restored}; {paper['stats']['submitted']} "
                             f"tasks at {MOLDYN_PAPER_MOLECULES} molecules")

    mt = timed_example("montage", montage_workflow.run, device="cuda")
    mt_err = close_all("montage", [mt["mosaic"]], [montage_workflow.run(device="cpu")["mosaic"]],
                       EXAMPLE_TOL)
    log("example_montage", diff_fits=mt["diff_fits"], max_abs_err=mt_err, stats=mt["stats"])
    if mt["diff_fits"] != 16 - 1:
        raise AssertionError(f"montage: {mt['diff_fits']} mDiffFit tasks for 16 images")

    fm = timed_example("fmri", fmri_workflow.run, device="cuda")
    fm_err = close_all("fmri", fm["resliced"], fmri_workflow.run(device="cpu")["resliced"],
                       FIT_TOL)
    log("example_fmri", volumes=len(fm["resliced"]), max_abs_err=fm_err, stats=fm["stats"],
        seconds=time.perf_counter() - t_phase)
    free_card()


def phase_train_memory(seed):
    """deepseek-v2-236b cut to 1 dense + 1 MoE layer at full width: one
    forward and backward of `forward_train` on the card, its peak of
    allocated bytes above what was allocated before, beside `op_cost`'s
    count of the bytes live during the same step on meta tensors (what the
    dry run's temp bytes count).  A measurement; nothing is held."""
    from repro_torch.configs import registry
    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_tree, tree_leaves, tree_map_desc

    t0 = time.perf_counter()
    cfg = registry.cut_depth(registry.get_config(MEMORY_ARCH), 1)
    descs = T.build_descriptors(cfg)
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (MEMORY_BATCH, TRAIN_SEQ))
                                 .astype(np.int32)) for k in ("tokens", "labels")}

    def step(params, batch):
        loss, _ = T.forward_train(cfg, params, batch)
        loss.backward()
        return loss

    def meta(d):
        t = torch.empty(d.shape, dtype=d.dtype or torch.float32, device="meta")
        return t.requires_grad_() if t.is_floating_point() else t

    counted = op_cost.analyze(step, tree_map_desc(meta, descs),
                              {k: v.to("meta") for k, v in batch.items()}).peak_bytes
    free_card()
    params = init_tree(descs, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    for t in tree_leaves(params):
        if t.is_floating_point():
            t.requires_grad_()
    batch = {k: v.to("cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    loss = step(params, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    measured = torch.cuda.max_memory_allocated() - before
    log("train_memory", arch=cfg.name, layers="1 dense + 1 MoE", batch=MEMORY_BATCH,
        seq_len=TRAIN_SEQ, params=cfg.param_count(), param_bytes=before,
        measured_peak_bytes=measured, counted_peak_bytes=counted,
        counted_over_measured=counted / measured, loss=float(loss.detach()), step_s=step_s,
        card=smi_name_and_limit(), seconds=time.perf_counter() - t0)
    del params, batch, loss
    free_card()


# ---------------------------------------------------------------------------
# 4e-4g. the tooling: compression, the elastic mesh, the dry run
# ---------------------------------------------------------------------------

def tie_free(n: int, gen) -> torch.Tensor:
    """n f32 values with distinct |x|: consecutive bit patterns from 1.0 up,
    in a random order, with random signs."""
    bits = torch.randperm(n, generator=gen, device="cuda", dtype=torch.int32) + 0x3F800000
    sign = torch.rand(n, generator=gen, device="cuda") < 0.5
    x = bits.view(torch.float32)
    return torch.where(sign, -x, x)


def phase_compression(seed):
    """Error-feedback compression of full-width qwen2-1.5b's gradient shapes
    on the card: int8, then top-k at 1%, 3 steps each."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves, tree_map_desc
    from repro_torch.optim import compression as comp

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    descs = T.build_descriptors(registry.get_config(COMPRESSION_ARCH))
    big = max(tree_leaves(descs, is_leaf=lambda d: hasattr(d, "axes")),
              key=lambda d: math.prod(d.shape))

    def draw(d):
        if d is big:
            return tie_free(math.prod(d.shape), gen).reshape(d.shape)
        return torch.randn(d.shape, generator=gen, device="cuda")

    grads = tree_map_desc(draw, descs)
    g_leaves = tree_leaves(grads)
    f32_bytes = sum(g.numel() * 4 for g in g_leaves)
    ibig = next(i for i, g in enumerate(g_leaves) if g.shape == big.shape)
    for scheme in ("int8", "topk"):
        residual = comp.init_residual(grads)
        for step in range(COMPRESSION_STEPS):
            r_in = tree_leaves(residual)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            c, residual, deq = comp.compress_with_feedback(grads, residual, scheme=scheme,
                                                           topk_frac=TOPK_FRAC)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            err = max(float((r - ((g + r0) - q).float()).abs().max())
                      for r, g, r0, q in zip(tree_leaves(residual), g_leaves, r_in,
                                             tree_leaves(deq)))
            row = dict(scheme=scheme, step=step, ms=dt * 1e3, gb_per_s=f32_bytes / dt / 1e9,
                       f32_bytes=f32_bytes, compressed_bytes=comp.compressed_bytes(c),
                       ratio=comp.compressed_bytes(c) / f32_bytes, leaves=len(g_leaves),
                       elements=f32_bytes // 4, residual_err=err)
            if step == 0:
                # the largest leaf, on the CPU from the same values
                ref, _, _ = comp.compress_with_feedback(
                    {"w": g_leaves[ibig].cpu()}, {"w": r_in[ibig].cpu()}, scheme=scheme,
                    topk_frac=TOPK_FRAC)
                same = all(torch.equal(a.cpu(), b) for a, b in zip(c[ibig], ref[0]))
                row.update(largest_leaf=list(big.shape), largest_leaf_equal_cpu=same)
                if not same:
                    raise AssertionError(f"compression {scheme}: the largest leaf's "
                                         "compressed form differs from the CPU's")
            log("compression", **row)
            if err > 1e-6:
                raise AssertionError(f"compression {scheme}: residual is not the input minus "
                                     f"the decompressed value ({err})")
            del c, deq, r_in
        del residual
    del grads, g_leaves
    free_card()
    log("compression_done", seconds=time.perf_counter() - t0)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_elastic(seed):
    """A one-rank NCCL group; full-width qwen2-1.5b's f32 parameters
    resharded onto `make_mesh_for_dp(1)` must come back bit-equal."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.distributed.elastic import make_mesh_for_dp, reshard_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_tree, tree_leaves

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    descs = T.build_descriptors(registry.get_config(COMPRESSION_ARCH))
    params = init_tree(descs, gen, "cuda")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        mesh = make_mesh_for_dp(1, device_type="cuda")
        t_mesh = time.perf_counter() - t0
        out = reshard_tree(params, descs, mesh)
        torch.cuda.synchronize()
        t_reshard = time.perf_counter() - t0 - t_mesh
        pairs = list(zip(tree_leaves(out), tree_leaves(params)))
        same = all(torch.equal(o.to_local(), p) for o, p in pairs)
        nbytes_ = sum(p.numel() * p.element_size() for _, p in pairs)
        log("elastic", mesh=str(mesh), mesh_s=t_mesh, reshard_s=t_reshard, leaves=len(pairs),
            bytes=nbytes_, gb_per_s=nbytes_ / t_reshard / 1e9, bit_equal=same,
            placements=sorted({str(o.placements) for o, _ in pairs}))
        if not same:
            raise AssertionError("elastic: resharded parameters differ from the originals")
        del out, pairs
    finally:
        dist.destroy_process_group()
    del params
    free_card()


def start_dryrun() -> tuple:
    """Start one dry-run process per cell (host only: the card is hidden)."""
    import os
    root = Path(__file__).resolve().parent
    out = root / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    for arch, shape in DRYRUN_CELLS:
        for ext in (".json", ".err"):
            (out / f"{arch}__{shape}__16x16{ext}").unlink(missing_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(root / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--out", str(out)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for arch, shape in DRYRUN_CELLS]
    return procs, out, time.perf_counter()


def phase_dryrun(started):
    """Wait for the dry-run processes; each must exit 0; log every cell."""
    procs, out, t0 = started
    for (arch, shape), p in zip(DRYRUN_CELLS, procs):
        text, _ = p.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        lines = text.splitlines()
        if p.returncode:
            raise AssertionError(f"dryrun {arch} {shape} exited {p.returncode}: "
                                 + "\n".join(lines[-20:]))
        rec = json.loads((out / f"{arch}__{shape}__16x16.json").read_text())
        r, m = rec["roofline"], rec["memory"]
        log("dryrun_cell", arch=arch, shape=shape, mesh=rec["mesh"], torch=lines[0],
            trace_s=rec["compile_s"], arg_gb=m["argument_bytes"] / 1e9,
            out_gb=m["output_bytes"] / 1e9, temp_gb=m["temp_bytes"] / 1e9,
            fits_80gb=m["fits_80gb"], flops=r["hlo_flops_per_device"],
            wire_bytes=r["collective_bytes_per_device"], compute_s=r["compute_term_s"],
            memory_s=r["memory_term_s"], collective_s=r["collective_term_s"],
            dominant=r["dominant"], useful=r.get("useful_flops_ratio"),
            mfu_bound=r.get("mfu_bound"), collectives=r["collective_ops"])
    log("dryrun", cells=len(procs), seconds=time.perf_counter() - t0,
        torch=torch.__version__)


# ---------------------------------------------------------------------------
# 5. kernel time at the serving shapes
# ---------------------------------------------------------------------------

def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sm_clock_mhz(fn, est_ms, seconds=1.5) -> float:
    """Median of the SM clock (MHz) that nvidia-smi samples every 50 ms
    while `fn` runs back to back for about `seconds`."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(max(1, int(seconds * 1e3 / est_ms))):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    samples = [float(x) for x in out.split()]
    if not samples:
        raise RuntimeError("nvidia-smi gave no SM clock")
    return statistics.median(samples)


def exp_floor_ms(n_exp, clock_mhz) -> float:
    """Least time the SFUs take for `n_exp` exponentials at this SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (sms * SFU_EXP_PER_CLOCK * clock_mhz * 1e6) * 1e3


def attended_pairs(S, causal, window) -> int:
    """(row, col) pairs of an S x S attention that the mask leaves unmasked
    (`ref_attention`'s: col <= row if causal, col > row - window if window)."""
    return sum((r if causal else S - 1) - (max(0, r - window + 1) if window else 0) + 1
               for r in range(S))


def time_flash(gen, shape, window, causal=True, dtype=torch.bfloat16, layout="bshd"):
    """The kernel at one shape of the main path (a serving shape: bf16, the
    strided views; quickstart's: f32, contiguous), beside its bound, the
    SFU's floor, its plain version and one PyTorch call that computes the
    same function: SDPA where the mask is causal over all rows or absent;
    for a window shorter than the prompt, SDPA with the explicit boolean
    band mask on its memory-efficient backend (which takes a mask), the kv
    heads expanded before the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import ref_attention
    s = shape
    q, k, v = attn_inputs(gen, *s.values(), dtype, layout)
    mask = dict(causal=causal, window=window)
    run = lambda: flash_attention(q, k, v, **mask)  # noqa: E731
    out = run()
    err = (out.float() - ref_attention(q, k, v, **mask).float()).abs().max().item()
    ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: ref_attention(q, k, v, **mask), reps=5)
    if window == 0 or (causal and window >= s["S"]):
        library = "sdpa"
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    else:
        library = "sdpa, memory-efficient backend, boolean band mask"
        g = s["Hq"] // s["Hkv"]
        ke, ve = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        rows = torch.arange(s["S"], device="cuda")[:, None]
        cols = torch.arange(s["S"], device="cuda")[None, :]
        band = cols > rows - window
        if causal:
            band &= cols <= rows
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=band))
        del ke, ve, band
    pairs = attended_pairs(s["S"], causal, window)
    flops = 4 * s["B"] * s["Hq"] * s["D"] * pairs               # QK^T and PV
    b_ms, by = bound(flops, nbytes(q, k, v, out),
                     PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    n_exp = s["B"] * s["Hq"] * pairs                            # one per unmasked score
    clock = sm_clock_mhz(run, ms)
    floor = exp_floor_ms(n_exp, clock)
    log("kernel_time", kernel="flash_attention", shape=list(s.values()), causal=causal,
        window=window, dtype=str(dtype).removeprefix("torch."), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library=library, bound_ms=b_ms, bound_by=by, flops=flops, bytes=nbytes(q, k, v, out),
        exponentials=n_exp, sm_clock_mhz=clock, exp_floor_ms=floor, max_abs_err=err)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=by, exp_floor_ms=floor, max_abs_err=err)


def time_mamba(gen):
    from repro_torch.kernels.ops import mamba_scan
    from repro_torch.kernels.ref import ref_selective_scan
    s = MAMBA_SHAPE
    u, dt, A, Bm, Cm = mamba_inputs(gen, *s.values(), torch.bfloat16, MAMBA_DT_RANK)
    y, h = mamba_scan(u, dt, A, Bm, Cm)
    err = (y.float() - ref_selective_scan(u, dt, A, Bm, Cm)[0]).abs().max().item()
    run = lambda: mamba_scan(u, dt, A, Bm, Cm)  # noqa: E731
    ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: ref_selective_scan(u, dt, A, Bm, Cm), reps=2, warmup=1)
    n = s["B"] * s["S"] * s["D"]
    # per state element: dt*A, exp, dBu, the state update (2), y_t (2); per channel: dt*u
    flops = 7 * n * s["N"] + n
    moved = nbytes(u, dt, y, A, h) + 2 * s["B"] * s["S"] * s["N"] * Bm.element_size()
    b_ms, by = bound(flops, moved, PEAK_F32_FLOPS)
    n_exp = n * s["N"]                                          # one per state element
    clock = sm_clock_mhz(run, ms)
    floor = exp_floor_ms(n_exp, clock)
    log("kernel_time", kernel="mamba_scan", shape=list(s.values()), dtype="bfloat16",
        b_row_stride=Bm.stride(1), ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
        bound_by=by, flops=flops, bytes=moved, exponentials=n_exp, sm_clock_mhz=clock,
        exp_floor_ms=floor, max_abs_err=err)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=by,
                exp_floor_ms=floor, max_abs_err=err)


def time_rglru(gen):
    from repro_torch.kernels.ops import rglru_scan
    from repro_torch.kernels.ref import ref_linear_scan
    s = RGLRU_SHAPE
    a, b, _ = rglru_inputs(gen, *s.values(), torch.float32)
    h0 = torch.zeros(s["B"], s["W"], device="cuda")            # as the main path passes it
    y, h = rglru_scan(a, b, h0)
    err = (y - ref_linear_scan(a, b, h0)[0]).abs().max().item()
    ms = cuda_ms(lambda: rglru_scan(a, b, h0))
    plain_ms = cuda_ms(lambda: ref_linear_scan(a, b, h0), reps=3, warmup=1)
    flops = 2 * a.numel()
    b_ms, by = bound(flops, nbytes(a, b, h0, y, h), PEAK_F32_FLOPS)
    log("kernel_time", kernel="rglru_scan", shape=list(s.values()), dtype="float32",
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=by, flops=flops,
        bytes=nbytes(a, b, h0, y, h), max_abs_err=err)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=by,
                max_abs_err=err)


SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:56"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:48"),
}


# one `kernels` entry per kernel and serving shape: (entry name, kernel, arch)
ENTRIES = (("flash_attention@qwen2-1.5b", "flash_attention", "qwen2-1.5b"),
           ("flash_attention@recurrentgemma-9b", "flash_attention", "recurrentgemma-9b"),
           ("flash_attention@granite-moe-3b-a800m", "flash_attention", "granite-moe-3b-a800m"),
           ("mamba_scan", "mamba_scan", "falcon-mamba-7b"),
           ("rglru_scan", "rglru_scan", "recurrentgemma-9b"),
           ("flash_attention@qwen1.5-0.5b", "flash_attention", "qwen1.5-0.5b"),
           ("flash_attention@stablelm-12b", "flash_attention", "stablelm-12b"),
           ("flash_attention@gemma3-27b-local", "flash_attention", "gemma3-27b"),
           ("flash_attention@gemma3-27b-global", "flash_attention", "gemma3-27b"),
           ("flash_attention@qwen2-vl-7b", "flash_attention", "qwen2-vl-7b"),
           ("flash_attention@whisper-large-v3-encoder", "flash_attention", "whisper-large-v3"),
           ("flash_attention@quickstart", "flash_attention", "quickstart"))


def phase_kernel_time(gen, launches, worst_err) -> list:
    """One entry of the `kernels` line per kernel and serving shape, each
    with the launches of the arch whose prefill gives that shape (for
    gemma3-27b's two entries, its 62 flash launches of both kinds) and the
    times at that shape; and one for quickstart's flash call, with the
    examples phase's launch."""
    timed = {"flash_attention@qwen2-1.5b": time_flash(gen, SERVE_SHAPE, 0),
             "flash_attention@recurrentgemma-9b": time_flash(gen, LOCAL_SHAPE, LOCAL_WINDOW),
             "flash_attention@granite-moe-3b-a800m": time_flash(gen, GRANITE_SHAPE, 0),
             "mamba_scan": time_mamba(gen), "rglru_scan": time_rglru(gen),
             "flash_attention@qwen1.5-0.5b": time_flash(gen, QWEN15_SHAPE, 0),
             "flash_attention@stablelm-12b": time_flash(gen, STABLELM_SHAPE, 0),
             "flash_attention@gemma3-27b-local": time_flash(gen, GEMMA3_SHAPE, GEMMA3_WINDOW),
             "flash_attention@gemma3-27b-global": time_flash(gen, GEMMA3_SHAPE, 0),
             "flash_attention@qwen2-vl-7b": time_flash(gen, QWEN2VL_SHAPE, 0),
             "flash_attention@whisper-large-v3-encoder": time_flash(gen, WHISPER_ENC_SHAPE, 0,
                                                                     causal=False),
             "flash_attention@quickstart": time_flash(gen, QUICKSTART_SHAPE, QUICKSTART_WINDOW,
                                                      dtype=torch.float32, layout="bhsd")}
    out = []
    for name, kernel, arch in ENTRIES:
        t = timed[name]
        source, replaces = SOURCES[kernel]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[arch][kernel],
                 "max_abs_err": max(t["max_abs_err"], worst_err[kernel]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if "exp_floor_ms" in t:         # the SFU's floor, beside the guide's bound
            entry["exp_floor_ms"] = t["exp_floor_ms"]
        out.append(entry)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    phase_build()
    worst = {"flash_attention": phase_flash_vs_plain(gen),
             "mamba_scan": phase_mamba_vs_plain(gen),
             "rglru_scan": phase_rglru_vs_plain(gen)}
    for arch in ARCHS:
        phase_small_model(arch, seed)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    for arch in ARCHS:
        phase_train_small(arch, seed)
    phase_train(seed)
    train_launches = {name: w.launches for name, w in ws.items()}
    log("train_launches", launches=train_launches)
    if any(train_launches.values()):
        raise AssertionError(f"a kernel was launched while training: {train_launches}")
    launches = {arch: phase_serve(arch, seed) for arch in ARCHS}
    phase_device_tier(seed)
    for w in ws.values():
        w.launches = 0
    phase_trainer(seed)
    phase_reliability(seed)
    phase_vmap_clustering(seed)
    reliability_launches = {name: w.launches for name, w in ws.items()}
    log("reliability_launches", launches=reliability_launches)
    if any(reliability_launches.values()):
        raise AssertionError(f"the trainer, reliability or clustering phase launched a kernel: "
                             f"{reliability_launches}")
    for w in ws.values():
        w.launches = 0
    phase_examples(seed)
    launches["quickstart"] = {name: w.launches for name, w in ws.items()}
    log("examples_launches", launches=launches["quickstart"])
    if launches["quickstart"] != {"flash_attention": 1, "mamba_scan": 0, "rglru_scan": 0}:
        raise AssertionError(f"the examples phase launched {launches['quickstart']}; "
                             f"quickstart's one flash call should be the only launch")
    for w in ws.values():
        w.launches = 0
    phase_train_memory(seed)
    memory_launches = {name: w.launches for name, w in ws.items()}
    if any(memory_launches.values()):
        raise AssertionError(f"the train_memory phase launched a kernel: {memory_launches}")
    for w in ws.values():
        w.launches = 0
    dry = start_dryrun()
    try:
        phase_compression(seed)
        phase_elastic(seed)
        phase_dryrun(dry)
    finally:
        for p in dry[0]:
            p.kill()
            p.wait()
    tooling_launches = {name: w.launches for name, w in ws.items()}
    log("tooling_launches", launches=tooling_launches)
    if any(tooling_launches.values()):
        raise AssertionError(f"the compression, elastic or dryrun phase launched a kernel: "
                             f"{tooling_launches}")
    kernels = phase_kernel_time(gen, launches, worst)
    log("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(smi_name_and_limit())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
