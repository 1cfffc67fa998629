"""Device-batched executor pool: fuse tiny tasks into vmapped dispatches.

The counterpart of the JAX package's `repro/core/devicepool.py`, on one
torch device (a CUDA card unless the caller passes ``device="cpu"``), with
one CUDA stream per dispatcher thread.

The paper's task clustering (§3.13) amortizes per-job batch-scheduler
overhead; on an accelerator the analogous cost is per-task dispatch + kernel
launch.  `DeviceExecutorPool` closes that loop behind the same
``submit(task, done, stage=None)`` seam as the real pools
(`repro_torch.core.realpool`, DESIGN.md §10/§11): ready tasks sharing a
`vmap_signature` accumulate into bundles, and each bundle executes as ONE
`torch.func.vmap` device call — one launch per op for K tiny tasks — on a
dedicated dispatcher thread.  Per-task completions fan back through
`Clock.post_release`, and the measured bundle time is attributed per task
into bounded `StreamStat`s.

Wiring is identical to the other pools::

    clock = RealClock()
    pool = DeviceExecutorPool(clock, max_bundle=256, device="cuda")
    svc = FalkonService(clock, cfg, pool=pool)
    eng = Engine(clock)
    eng.add_site("dev", FalkonProvider(svc), capacity=256)
    ... submit tasks with vmap_key=... ...
    eng.run(); svc.shutdown()

Batching contract: a task is *batchable* when it carries both a callable
and a ``vmap_key`` (the same opt-in `VmapClusteringProvider` uses — the
user asserts the body is a pure, vmappable torch function).  Everything else
runs as a measured singleton on the dispatcher thread, so mixed workloads
need no special casing.  Composition with the rest of the stack is
unchanged: DRP provisioning still sizes the *logical* executor set (the
pool is fixed — one device does not grow threads), the data layer's
`stage` closures run on the dispatcher thread inside the measured staging
time, and `foreach(window=)` / federation operate above the pool seam.

Threading contract (DESIGN.md §10): `submit` and `flush` run on the clock
thread; dispatcher threads touch only the bundle queue, the vmap cache,
their own CUDA stream, and `post`/`release`; completions and all counters
run back on the clock thread.  Each dispatcher makes the pool's card its
current device (the current device is per thread) and runs every bundle on
its own stream, synchronized before the bundle's time is attributed.  An
error outside the task bodies (a CUDA error surfacing at the stream's
synchronize) fails that bundle's tasks instead of killing the thread, so
`run()` never waits on completions that cannot come.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from functools import partial
from time import perf_counter
from typing import Any, Callable, Optional

import torch

from repro_torch.core.clustering import (execute_bundle, resolve_args,
                                         vmap_signature)
from repro_torch.core.metrics import StreamStat
from repro_torch.core.realpool import _require_threadsafe_clock
from repro_torch.core.simclock import Clock
from repro_torch.device import resolve_device

_STOP = object()


class DeviceExecutorPool:
    """Real pool whose dispatch loop fuses same-signature tasks into one
    vmapped device call (DESIGN.md §11).

    Knobs: `max_bundle` caps the fuse width (a full bucket flushes
    immediately); `linger` is the bundling window in clock seconds —
    with the default ``0.0`` a flush is scheduled behind the current
    event cascade, so every task dispatched in one scheduler pump (up to
    the site's throttle) lands in the same bundle without adding latency;
    `dispatchers` is the number of device-feeding threads (one CUDA
    stream each; the default 1 matches a single accelerator's serial
    launch queue); `device` is where every bundle runs, resolved with
    `repro_torch.device.resolve_device` (the default ``"cuda"`` raises
    without a card).

    Measured, not priced: `done(ok, value, err, io_s, run_s)` receives the
    staging seconds observed for that task and its share of the bundle's
    measured execution time (`bundle_s / K`).  `device_s` accumulates the
    total seconds the dispatcher spent inside device execution — the
    numerator of the benchmark's "device-bound, not dispatcher-bound"
    fraction (benchmarks/device_batching.py).
    """

    autoscale = False

    def __init__(self, clock: Clock, max_bundle: int = 256,
                 linger: float = 0.0, dispatchers: int = 1,
                 name: str = "device", tracer=None, device="cuda"):
        if max_bundle < 1:
            raise ValueError("max_bundle must be >= 1")
        _require_threadsafe_clock(clock, name)
        self.device = resolve_device(device)
        self.clock = clock
        self.name = name
        # observability (DESIGN.md §12): each fused bundle emits one
        # `bundle_fused` event (value = tasks fused); clock thread only
        self.tracer = tracer
        self.max_bundle = max_bundle
        self.linger = linger
        self._pending: dict[Any, list] = {}
        self._flush_scheduled = False
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._vmapped_cache: dict = {}
        self._shutdown = False
        # streams are made here, on the caller's thread, so a failure to
        # make one raises from the constructor, not inside a dispatcher
        n = max(1, dispatchers)
        self._streams = ([torch.cuda.Stream(self.device) for _ in range(n)]
                         if self.device.type == "cuda" else [None] * n)
        self._threads = [
            threading.Thread(target=self._loop, args=(s,), daemon=True,
                             name=f"{name}-dispatch{i}")
            for i, s in enumerate(self._streams)
        ]
        for t in self._threads:
            t.start()
        # counters/summaries — mutated on the clock thread only
        self.tasks_run = 0
        self.bundles_run = 0
        self.fused_tasks = 0
        self.device_s = 0.0                  # measured execution seconds
        self.io_stat = StreamStat(cap=256)   # measured staging s per task
        self.run_stat = StreamStat(cap=256)  # attributed execution s per task
        self.bundle_stat = StreamStat(cap=256)  # tasks per bundle

    def size(self) -> int:
        return len(self._threads)

    def resize(self, n: int) -> None:
        """Fixed-size by design: DRP allocations size the *logical*
        executor set, not device streams (`autoscale` is False, so the
        service never calls this on the real path)."""

    # -- the seam (clock thread) ----------------------------------------
    def submit(self, task, done: Callable,
               stage: Optional[Callable[[], None]] = None) -> None:
        """Hand one task to the dispatcher.  Batchable tasks (callable +
        `vmap_key`) accumulate per `vmap_signature` until `max_bundle` or
        the `linger` flush; others ship immediately as singletons.
        `done(ok, value, err, io_s, run_s)` is called back on the clock
        thread, once per task."""
        if self._shutdown:
            raise RuntimeError(f"pool {self.name!r} is shut down")
        self.clock.hold()
        if task.vmap_key is None or task.fn is None:
            self._q.put([(task, done, stage)])
            return
        key = (task.vmap_key, vmap_signature(task.fn, resolve_args(task)))
        bucket = self._pending.get(key)
        if bucket is None:
            self._pending[key] = bucket = []
        bucket.append((task, done, stage))
        if len(bucket) >= self.max_bundle:
            del self._pending[key]
            self._q.put(bucket)
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            self.clock.schedule(self.linger, self.flush)

    def flush(self) -> None:
        """Ship every pending bucket to the dispatcher (clock thread)."""
        self._flush_scheduled = False
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        for bundle in pending.values():
            self._q.put(bundle)

    def shutdown(self, wait: bool = True) -> None:
        """Stop the dispatcher threads (after their queued bundles) and
        join them.  Call after `run()` returns; queued work has completed."""
        if self._shutdown:
            return
        self._shutdown = True
        for _ in self._threads:
            self._q.put(_STOP)
        if wait:
            for t in self._threads:
                t.join()
        self._threads.clear()

    # -- dispatcher side -------------------------------------------------
    def _loop(self, stream) -> None:
        ctx = (contextlib.nullcontext() if stream is None else
               torch.cuda.device(self.device))
        with ctx:
            while True:
                bundle = self._q.get()
                if bundle is _STOP:
                    return
                self._run_bundle(bundle, stream)

    def _execute(self, tasks: list, stream):
        """`execute_bundle` on this dispatcher's stream, synchronized; an
        error it lets through (the stream's synchronize) fails every task."""
        ctx = (contextlib.nullcontext() if stream is None else
               torch.cuda.stream(stream))
        t0 = perf_counter()
        try:
            with ctx:
                results, exec_s, n_fused = execute_bundle(
                    tasks[0].fn, tasks, self._vmapped_cache, self.device)
            if stream is not None:
                stream.synchronize()
        except Exception as err:  # noqa: BLE001 — surface, do not hang
            return [(False, None, err)] * len(tasks), perf_counter() - t0, 0
        return results, exec_s, n_fused

    def _run_bundle(self, bundle: list, stream=None) -> None:
        # real staging copies first, per task, inside the measured io time
        # (exactly where the simulated path adds priced staging I/O);
        # a staging failure fails that task and drops it from the batch
        io_ss = [0.0] * len(bundle)
        staged_err: dict[int, BaseException] = {}
        for i, (_task, _done, stage) in enumerate(bundle):
            if stage is None:
                continue
            t0 = perf_counter()
            try:
                stage()
            except BaseException as err:  # noqa: BLE001 — staging failure
                staged_err[i] = err
            io_ss[i] = perf_counter() - t0
        live = [i for i in range(len(bundle)) if i not in staged_err]
        tasks = [bundle[i][0] for i in live]
        if tasks:
            results, exec_s, n_fused = self._execute(tasks, stream)
        else:
            results, exec_s, n_fused = [], 0.0, 0
        # measured bundle time attributed evenly across the tasks that
        # actually executed; staged-failure tasks carry only their io time
        out: list = [None] * len(bundle)
        run_ss = [0.0] * len(bundle)
        per_task = exec_s / max(1, len(live))
        for i, err in staged_err.items():
            out[i] = (False, None, err)
        for i, res in zip(live, results):
            out[i] = res
            run_ss[i] = per_task
        # one posted completion per bundle; the post lands before any
        # hold token is returned, so the loop can never observe
        # "no holds, no events" mid-handoff
        self.clock.post(partial(self._complete_bundle, bundle, out,
                                io_ss, run_ss, exec_s, n_fused))
        for _ in bundle:
            self.clock.release()

    # -- back on the clock thread ----------------------------------------
    def _complete_bundle(self, bundle, out, io_ss, run_ss, exec_s,
                         n_fused) -> None:
        now = self.clock.now()
        self.bundles_run += 1
        self.device_s += exec_s
        self.bundle_stat.observe(now, len(bundle))
        self.fused_tasks += n_fused
        if self.tracer is not None and n_fused:
            self.tracer.event("bundle_fused", now, n_fused)
        tr = self.tracer
        for (task, done, _stage), (ok, v, err), io_s, run_s in zip(
                bundle, out, io_ss, run_ss):
            self.tasks_run += 1
            self.io_stat.observe(now, io_s)
            self.run_stat.observe(now, run_s)
            if tr is not None and not ok:
                # worker-level failure signal (DESIGN.md §13), same kind
                # the thread/process pools emit
                tr.event("worker_error", now)
            done(ok, v, err, io_s, run_s)

    def metrics(self) -> dict:
        """Bounded snapshot — safe at any task count."""
        return {
            "device": str(self.device),
            "dispatchers": self.size(),
            "tasks_run": self.tasks_run,
            "bundles_run": self.bundles_run,
            "fused_tasks": self.fused_tasks,
            "device_s": self.device_s,
            "bundle_size": self.bundle_stat.summary(),
            "io_s": self.io_stat.summary(),
            "run_s": self.run_stat.summary(),
        }
