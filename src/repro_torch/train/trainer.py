"""Engine-driven trainer: training as a Swift workflow (DESIGN.md §3).

The port of the JAX package's `repro/train/trainer.py`.  Every unit of work
— host data staging, the train step itself, periodic evals, checkpoint
writes — is a task in the Karajan engine, linked by data futures:

    data(i)  ──┐
               ├─> step(i) ──> params(i+1) ──> step(i+1) ...
    params(i) ─┘         └──> eval(i)   (pipelined, off critical path)
                         └──> ckpt(i)   (durable artifact -> manifest)

Fault tolerance comes from the engine (retries on injected/transient step
failures) plus the checkpoint manifest (data-availability restart, §3.12):
`fit()` resumes from the latest durable step after a crash.

The port's train step updates the parameters and AdamW's moments in place,
where the reference's builds a new state each step.  So `step(i+1)` also
waits for the eval and checkpoint tasks that read the state after i+1
steps: whichever order the engine runs ready tasks in, they read that state
and not a later one.  An injected fault fails a step before its body runs,
so a retry starts from the state it was given.

The state (an f32 master copy and AdamW's moments) lives on `device`, the
card unless the caller passes ``device="cpu"``; batches are moved there
inside the step task.  The plain attention and scans run (the kernels are
forward-only), as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core import Engine, RealClock, Workflow
from repro_torch.core.faults import FaultInjector, RetryPolicy
from repro_torch.core.futures import resolved
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import init_params
from repro_torch.train.steps import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 20
    ckpt_every: int = 10
    eval_every: int = 5
    log_every: int = 1
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, hp: adamw.Hyper, dcfg: DataConfig,
                 workdir: str, tcfg: TrainerConfig | None = None,
                 fault_injector: FaultInjector | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.hp = hp
        self.dcfg = dcfg
        self.workdir = workdir
        self.tcfg = tcfg or TrainerConfig()
        self.device = resolve_device(device)
        self.data = SyntheticLM(cfg, dcfg)
        self.ckpt = Checkpointer(os.path.join(workdir, "ckpt"))
        self.fault_injector = fault_injector
        self._train_step = make_train_step(cfg, hp)
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self):
        params = init_params(self.cfg, self.tcfg.seed, self.device)
        return params, adamw.init(params)

    def restore_or_init(self):
        params, opt = self.init_state()
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt, 0
        state, step = self.ckpt.restore({"params": params, "opt": opt})
        return state["params"], state["opt"], step

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def fit(self, steps: int | None = None) -> list[dict]:
        """Run the steps from the newest checkpoint (or 0) to `steps`
        (default `tcfg.total_steps`); returns the history: one row per step
        (the train step's metrics, `step`, `step_time` in seconds after the
        device finished) and per eval (`step`, `eval_loss`).  Also sets
        `engine_stats`, `vdc`, and `setup_s` and `run_s`: the host seconds
        of restoring (or drawing) the state and of the workflow's run."""
        total = steps or self.tcfg.total_steps
        t0 = time.monotonic()
        params, opt, start = self.restore_or_init()
        synchronize(self.device)
        self.setup_s = time.monotonic() - t0

        engine = Engine(RealClock(),
                        retry_policy=RetryPolicy(max_retries=3),
                        fault_injector=self.fault_injector)
        engine.local_site(concurrency=1)
        wf = Workflow("train", engine)

        def stage_data(step):
            return self.data.global_batch(step)

        def do_step(state, batch, step, *_readers):
            params, opt = state
            batch = self._to_device(batch)
            synchronize(self.device)
            t0 = time.monotonic()
            params, opt, metrics = self._train_step(params, opt, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            synchronize(self.device)
            metrics["step"] = step
            metrics["step_time"] = time.monotonic() - t0
            self.history.append(metrics)
            return params, opt

        def do_eval(state, step):
            params, _ = state
            batch = self._to_device(self.data.batch(10_000_000 + step))  # held-out stream
            with torch.no_grad():
                loss, _ = T.forward_train(self.cfg, params, batch)
            rec = {"step": step, "eval_loss": float(loss)}
            self.history.append(rec)
            return rec

        def do_ckpt(state, step):
            params, opt = state
            self.ckpt.save(step, {"params": params, "opt": opt})
            return step

        step_proc = wf.atomic(do_step, name="train_step")
        data_proc = wf.atomic(stage_data, name="stage_data")
        eval_proc = wf.atomic(do_eval, name="eval")
        ckpt_proc = wf.atomic(do_ckpt, name="checkpoint")

        state_f = resolved((params, opt), name="state0")
        side = []
        readers = []        # the tasks that read state_f before it changes
        for s in range(start, total):
            batch_f = data_proc(s)               # stages while prev step runs
            state_f = step_proc(state_f, batch_f, s, *readers)
            readers = []
            if self.tcfg.eval_every and (s + 1) % self.tcfg.eval_every == 0:
                readers.append(eval_proc(state_f, s + 1))
            if self.tcfg.ckpt_every and (s + 1) % self.tcfg.ckpt_every == 0:
                readers.append(ckpt_proc(state_f, s + 1))
            side.extend(readers)
        final = wf.gather([state_f] + side, name="train_done")
        t0 = time.monotonic()
        wf.run()
        self.run_s = time.monotonic() - t0
        if final.failed:
            raise final._error
        self.vdc = engine.vdc
        self.engine_stats = engine.stats()
        return self.history
