"""Train a model for a few steps on synthetic data.

Two ways, both at full width by default:
  * `train()`, the bare step loop (no engine, no checkpoints);
  * with ``--workdir DIR``, `repro_torch.train.trainer.Trainer.fit`, the
    port's counterpart of `examples/train_lm.py`: every step, data stage,
    eval and checkpoint is a task of the workflow engine (an eval on a
    held-out batch and a checkpoint under DIR/ckpt every 2 steps), and a
    second run on the same DIR resumes from the newest checkpoint there
    (``--steps`` counts from step 0, so a resumed run trains the steps
    between that checkpoint and ``--steps``).
  The parameters are an f32 master copy drawn from
a seeded `torch.Generator` on the device; the layers compute in the
config's compute dtype (bf16 for the repo's configs), each weight cast at
use.  Batches come from `SyntheticLM`, AdamW with a warmup-cosine schedule
steps the parameters, and the plain attention and scans run (`use_pallas`
is off: the kernels are forward-only).

Per step it prints loss, grad_norm, lr and step ms (host clock, after the
device finished).  At the end: tokens/s over the steps after the first, the
peak device memory, and the model-FLOPs share of the card's 989 TFLOP/s
bf16 peak (H100 SXM, dense).  Model FLOPs per step are

    6 * N * B * S  +  6 * B * sum over attention layers of H * (Dqk + Dv) * P

with N the active parameters that enter a matrix product (all of them but
an untied input embedding table; of a MoE layer's routed experts only the
top-k), H the query heads, Dqk and Dv the widths of the QK^T and PV
products (the head dim for GQA; nope + rope and v_dim for MLA) and P the
(query, key) pairs one sequence attends (S (S + 1) / 2 for causal
attention, fewer under a window): forward, backward, no recompute counted.

Run:  PYTHONPATH=src python -m repro_torch.train [--arch qwen2-1.5b |
          falcon-mamba-7b | recurrentgemma-9b | granite-moe-3b-a800m |
          deepseek-v2-236b] [--smoke] [--steps 6]
          [--seq-len 4096] [--batch 8] [--microbatches 4] [--device cuda]
          [--workdir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer as T
from repro_torch.models.params import init_tree
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate


def model_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Model FLOPs of one train step over `batch` sequences of `seq` tokens
    (the formula in the module docstring)."""
    n = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_padded * cfg.d_model
    attn = 0
    for pattern, reps in cfg.blocks:
        for spec in pattern:
            if spec.mixer == "attn":
                w = spec.window if spec.window > 0 else seq
                pairs = sum(min(r + 1, w) for r in range(seq))
                attn += reps * cfg.n_heads * 2 * cfg.head_dim * pairs
            elif spec.mixer == "mla":
                widths = cfg.mla_nope_dim + cfg.mla_rope_dim + cfg.mla_v_dim
                attn += reps * cfg.n_heads * widths * seq * (seq + 1) // 2
    return 6.0 * n * batch * seq + 6.0 * batch * attn


def init_params(cfg: ModelConfig, seed: int, device):
    """The f32 master copy, drawn from `seed` on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_tree(T.build_descriptors(cfg), gen, dev, dtype=None)


def train(cfg: ModelConfig, *, steps: int, seq_len: int, batch: int,
          microbatches: int, seed: int = 0, device="cuda", params=None,
          log=lambda row: print(json.dumps(row), flush=True)) -> dict:
    """Run `steps` train steps on `SyntheticLM` batches from step 0.

    Returns {"steps": [per-step metrics as floats, with step_ms], and the
    summary: step_ms (median over the steps after the first), tokens_per_s
    and mfu (over the steps after the first), peak_mem_bytes}.  `mfu` and
    `peak_mem_bytes` are None off a CUDA device.  `params` (the f32 master
    copy, updated in place) defaults to `init_params(cfg, seed, device)`.
    Each step's metrics go to `log` as they come.
    """
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    hp = adamw.Hyper(lr=3e-4, warmup=2, total_steps=steps, microbatches=microbatches)
    opt = adamw.init(params)
    data = SyntheticLM(cfg, DataConfig(seed=seed, global_batch=batch, seq_len=seq_len))
    step_fn = make_train_step(cfg, hp)
    rows = []
    for step in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.global_batch(step).items()}
        synchronize(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b, step)
        synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}, "step_ms": ms}
        log(row)
        rows.append(row)
    later = [r["step_ms"] for r in rows[1:]]
    out = {"steps": rows, "step_ms": statistics.median(later) if later else None,
           "tokens_per_s": None, "mfu": None, "peak_mem_bytes": None}
    if later:
        out["tokens_per_s"] = batch * seq_len * len(later) / (sum(later) / 1e3)
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        if later:
            flops = model_flops(cfg, batch, seq_len) * len(later)
            out["mfu"] = flops / (sum(later) / 1e3) / PEAK_BF16_FLOPS
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=registry.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config (registry.smoke_config)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="train through Trainer.fit, checkpointing under "
                         "DIR/ckpt and resuming from there")
    args = ap.parse_args(argv)
    cfg = registry.smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    cfg = dataclasses.replace(cfg, use_pallas=False)
    if args.workdir is not None:
        return fit_main(cfg, args)
    res = train(cfg, steps=args.steps, seq_len=args.seq_len, batch=args.batch,
                microbatches=args.microbatches, seed=args.seed, device=args.device)
    dev = resolve_device(args.device)
    print(json.dumps({"summary": "train", "arch": cfg.name, "n_params": cfg.param_count(),
                      "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      **{k: v for k, v in res.items() if k != "steps"}}))
    return res


def fit_main(cfg: ModelConfig, args) -> list[dict]:
    """`main` with --workdir: the engine-driven `Trainer` on `args`."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    hp = adamw.Hyper(lr=3e-4, warmup=2, total_steps=args.steps,
                     microbatches=args.microbatches)
    dcfg = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq_len)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=2, eval_every=2,
                         seed=args.seed)
    tr = Trainer(cfg, hp, dcfg, args.workdir, tcfg, device=args.device)
    hist = tr.fit()
    for row in hist:
        print(json.dumps(row))
    steps = [r["step"] for r in hist if "loss" in r]
    print(json.dumps({"summary": "fit", "arch": cfg.name, "workdir": args.workdir,
                      "steps_run": steps, "checkpoints": tr.ckpt.steps(),
                      "setup_s": tr.setup_s, "run_s": tr.run_s,
                      **tr.engine_stats}))
    return hist


if __name__ == "__main__":
    main()
