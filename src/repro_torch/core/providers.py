"""Execution providers (paper §3.11) — the middle layer of the scheduler.

Providers implement the abstract provider interface: `submit(task,
when_done)` with `when_done(ok, value, error)` called exactly once per
submission.  The two pool-shaped providers (local host, simulated batch
scheduler) share `WorkerPoolProvider`, which owns the run queue / slot
accounting that the seed duplicated in both classes:

  * LocalProvider           — run on the submit host
  * BatchSchedulerProvider  — simulated PBS/Condor: serial submission rate +
                              scheduler latency + node pool (the GRAM+PBS
                              baseline of Figs 6/12/13/14)
  * FalkonProvider          — the Falkon service (multi-level scheduling)
  * ClusteringProvider      — wraps any provider, bundling small tasks within
                              a clustering window (§3.13)
"""
from __future__ import annotations

from collections import deque
from functools import partial
from typing import TYPE_CHECKING, Callable

from repro_torch.core.faults import TaskFailure
from repro_torch.core.futures import DataFuture
from repro_torch.core.simclock import Clock
from repro_torch.core.task import Task, execute_task, sim_duration

if TYPE_CHECKING:
    from repro_torch.core.falkon import FalkonService


class Provider:
    """Abstract execution provider (paper §3.11): `submit(task, when_done)`
    with ``when_done(ok, value, error)`` called exactly once per
    submission.  Implementations wrap a local pool, a simulated batch
    scheduler, the Falkon service, or another provider (clustering).

    Example — register any provider as an engine site::

        eng.add_site("cluster", BatchSchedulerProvider(clock, nodes=32),
                     capacity=32)
    """

    name = "provider"

    def submit(self, task: Task, when_done: Callable) -> None:
        raise NotImplementedError


class WorkerPoolProvider(Provider):
    """Shared worker-pool core: a FIFO run queue drained into a fixed number
    of execution slots.

    Subclasses control *admission* (when a submitted task reaches the run
    queue — immediately for the local host, after a gateway throttle plus
    scheduler latency for a batch system).  Draining is O(1) per task: each
    completion frees one slot and pulls the queue head; no scans.

    Simulated by default: a slot occupies the clock for the task's declared
    `duration` and the body executes at the scheduled completion.  Pass
    ``pool=`` (a `ThreadExecutorPool` / `ProcessExecutorPool`,
    DESIGN.md §10, or a `DeviceExecutorPool`, DESIGN.md §11 — any object
    with the ``submit(task, done, stage=None)`` seam) to run bodies on
    real workers instead — the slot is held for the *measured* run and
    durations are ignored::

        prov = LocalProvider(clock, 8, pool=ThreadExecutorPool(clock, 8))
    """

    name = "pool"

    def __init__(self, clock: Clock, slots: int, pool=None):
        self.clock = clock
        self.slots = slots
        self.pool = pool
        if pool is not None and pool.autoscale:
            pool.resize(slots)
        self._running = 0
        self._queue: deque = deque()

    # admission policy — subclasses may delay this
    def submit(self, task: Task, when_done: Callable) -> None:
        self._admit(task, when_done)

    def _admit(self, task: Task, when_done: Callable) -> None:
        self._queue.append((task, when_done))
        self._pump()

    def _pump(self) -> None:
        queue = self._queue
        clock = self.clock
        pool = self.pool
        while queue and self._running < self.slots:
            task, when_done = queue.popleft()
            self._running += 1
            task.start_time = clock.now()
            if pool is not None:
                # real execution: the body runs on a worker; the measured
                # completion re-enters on the clock thread
                pool.submit(task, partial(self._finish_real, task, when_done))
            else:
                clock.schedule(sim_duration(task),
                               partial(self._finish, task, when_done))

    def _finish(self, task: Task, when_done: Callable) -> None:
        ok, value, err = execute_task(task)
        self._running -= 1
        when_done(ok, value, err)
        self._pump()

    def _finish_real(self, task: Task, when_done: Callable,
                     ok: bool, value, err, io_s: float,
                     run_s: float) -> None:
        self._running -= 1
        when_done(ok, value, err)
        self._pump()


class LocalProvider(WorkerPoolProvider):
    """Immediate local execution (the paper's local-host provider).

    Example::

        eng = Engine(clock)
        eng.add_site("localhost", LocalProvider(clock, concurrency=4),
                     capacity=4)
    """

    name = "local"

    def __init__(self, clock: Clock, concurrency: int = 1, pool=None):
        super().__init__(clock, concurrency, pool=pool)


class BatchSchedulerProvider(WorkerPoolProvider):
    """Simulated conventional batch scheduler (PBS / Condor).

    Models the paper's measured behavior: a serial job-submission throttle
    (GRAM gateway: ~1/5 jobs/s in §5.4.3; PBS ~1-2 jobs/s in Fig 12) plus a
    per-job scheduler latency, over a fixed node pool.

    Admissions are coalesced into *gateway-window waves* (PBS scheduling
    cycles): the seed scheduled one clock event per task through the
    gateway, which inflated the event heap at 10^6 tasks.  Per-job
    admission times (`gate + sched_latency`) are quantized onto wave
    boundaries: a wave opens at the first pending admission time and fires
    one clock event `admit_window` later (default `sched_latency / 8`),
    admitting every job whose per-job time falls inside the window — under
    backlog that is `admit_window x submit_rate` jobs per clock event.  A
    job is admitted no earlier than its per-job time and at most
    `admit_window` late, so the serial-gateway pacing that distinguishes
    e.g. PBS from Condor 6.7.2 (Fig 6/12) is preserved to within 1/8 of
    the scheduler latency; with `sched_latency == 0` waves are singletons
    and the per-job timing is exact.
    """

    name = "batch"

    def __init__(self, clock: Clock, nodes: int, submit_rate: float = 1.0,
                 sched_latency: float = 60.0,
                 admit_window: float | None = None, pool=None):
        super().__init__(clock, nodes, pool=pool)
        self.submit_interval = 1.0 / submit_rate
        self.sched_latency = sched_latency
        self.admit_window = (sched_latency / 8.0 if admit_window is None
                             else admit_window)
        self._gateway_free_at = 0.0
        self._wave: list | None = None
        self._wave_deadline = 0.0
        self.admission_events = 0   # clock events spent on admission

    def submit(self, task: Task, when_done: Callable) -> None:
        now = self.clock.now()
        # serial submission gateway (throttled)
        gate = max(now, self._gateway_free_at)
        self._gateway_free_at = gate + self.submit_interval
        admit_at = gate + self.sched_latency
        if self._wave is None or admit_at > self._wave_deadline:
            wave: list = []
            self._wave = wave
            self._wave_deadline = admit_at + self.admit_window
            self.admission_events += 1
            self.clock.schedule(self._wave_deadline - now,
                                partial(self._admit_wave, wave))
        self._wave.append((task, when_done))

    def _admit_wave(self, wave: list) -> None:
        if wave is self._wave:
            self._wave = None
        self._queue.extend(wave)
        self._pump()


class FalkonProvider(Provider):
    """Adapter registering a `FalkonService` as an engine site::

        svc = FalkonService(clock, FalkonConfig())
        eng.add_site("pod0", FalkonProvider(svc), capacity=64)
    """

    name = "falkon"

    def __init__(self, service: "FalkonService"):
        self.service = service

    def submit(self, task: Task, when_done: Callable) -> None:
        self.service.submit(task, when_done)


class ClusteringProvider(Provider):
    """Dynamic clustering (§3.13): accumulate ready tasks for a clustering
    window, then submit them as one bundle paying one per-job overhead.
    No prior knowledge of the workflow graph is needed."""

    name = "clustering"

    def __init__(self, clock: Clock, inner: Provider, window: float = 1.0,
                 bundle_size: int = 8):
        self.clock = clock
        self.inner = inner
        self.window = window
        self.bundle_size = bundle_size
        self._pending: deque = deque()
        self._flush_scheduled = False

    def submit(self, task: Task, when_done: Callable) -> None:
        self._pending.append((task, when_done))
        if len(self._pending) >= self.bundle_size:
            self._flush()
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            self.clock.schedule(self.window, self._window_flush)

    def _window_flush(self):
        self._flush_scheduled = False
        if self._pending:
            self._flush()

    def _flush(self):
        pending = self._pending
        bundle = [pending.popleft()
                  for _ in range(min(self.bundle_size, len(pending)))]
        if not bundle:
            return
        tasks = [t for t, _ in bundle]
        total = sum(sim_duration(t) for t in tasks)
        # the bundle stages the union of its members' inputs once, so
        # clustering composes with a data-layer Falkon (staging costs and
        # cache accounting are not silently dropped)
        inputs = {}
        for t in tasks:
            for obj in t.inputs:
                inputs[obj.name] = obj

        def run_bundle(*_):
            results = []
            for t, _cb in bundle:
                ok, value, err = execute_task(t)
                results.append((ok, value, err))
            return results

        meta = Task(name=f"bundle[{len(bundle)}]", fn=run_bundle, args=[],
                    output=DataFuture(), duration=total, app=tasks[0].app,
                    retries=0, durable=False, key="",
                    inputs=tuple(inputs.values()))
        meta.fault_check = None

        def done(ok, results, err):
            if not ok or results is None:
                for _t, cb in bundle:
                    cb(False, None, err or TaskFailure("bundle failed"))
                return
            for (t, cb), (ok_i, v_i, e_i) in zip(bundle, results):
                cb(ok_i, v_i, e_i)

        self.inner.submit(meta, done)
        if self._pending:
            self._flush()
