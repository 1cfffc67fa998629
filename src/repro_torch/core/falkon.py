"""Falkon: fast, lightweight task execution service (paper §4).

Multi-level scheduling: *resource provisioning* (DRP acquires executors,
paying the batch-scheduler allocation latency once) is decoupled from *task
dispatch* (streamlined, O(1), ~ms per task).  Executors register with the
service; queued tasks are dispatched to idle executors; DRP grows/shrinks the
pool on queue pressure; hosts with repeated failures are suspended
("stale NFS handle" handling, §3.12).

Scale behavior (DESIGN.md §2/§4): per-task dispatch cost is O(1) in both
queue depth and pool size — the idle-executor pool is a deque, the DRP
shrink sweep is amortized over the idle timeout instead of scanning every
executor on every completion, and metrics are bounded `StreamStat`
summaries.  Construct the service with ``trace=True`` to additionally keep
the raw per-event series (`queue_len_log`, `alloc_log`, per-executor
`task_log`) that the Fig-18-style benchmark views need — these live on a
`Tracer`'s bounded logs (DESIGN.md §12), so even a traced 10^6-task run
stays memory-bounded (the seed kept plain lists that grew O(tasks)).
Pass ``tracer=`` to share the engine's tracer, so DRP allocations and
affinity redirects land in the same trace as the task lifecycle spans.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

from repro_torch.core.faults import TaskFailure
from repro_torch.core.metrics import StreamStat
from repro_torch.core.observability import BoundedLog, Tracer
from repro_torch.core.simclock import Clock
from repro_torch.core.task import execute_task, sim_duration

# compat aliases — the seed exposed these as falkon-private helpers and
# other modules imported them from here
_execute = execute_task
_sim_duration = sim_duration


@dataclasses.dataclass
class DRPConfig:
    min_executors: int = 0
    max_executors: int = 64
    alloc_latency: float = 81.0      # GRAM4+PBS allocation latency (paper §5.4.3)
    alloc_chunk: int = 32            # executors acquired per allocation
    idle_timeout: float = 300.0      # de-register idle executors
    queue_per_executor: float = 1.0  # grow when queue > this x executors


@dataclasses.dataclass
class FalkonConfig:
    dispatch_overhead: float = 1.0 / 487.0   # paper: 487 tasks/s streamlined
    # serialize_dispatch=True models the dispatcher as a serial resource:
    # task starts are gated at one per `dispatch_overhead`, so a single
    # service saturates at the paper's 487 tasks/s no matter how many
    # executors it feeds (§4: the measured number is a *dispatcher*
    # throughput ceiling).  This is the regime multi-engine federation
    # (DESIGN.md §8) exists for — N shard services give N dispatchers.
    # Default False keeps the seed's per-task-overhead timing exactly.
    serialize_dispatch: bool = False
    drp: DRPConfig = dataclasses.field(default_factory=DRPConfig)
    host_fail_threshold: int = 2
    host_suspend_time: float = 60.0


class Executor:
    __slots__ = ("id", "host", "busy", "suspended_until", "consec_failures",
                 "idle_since", "busy_time", "tasks_done", "registered_at",
                 "task_log", "cache", "local_q", "local_work", "in_idle")

    def __init__(self, eid: int, host: str, now: float):
        self.id = eid
        self.host = host
        self.busy = False
        self.suspended_until = 0.0
        self.consec_failures = 0
        self.idle_since = now
        self.busy_time = 0.0
        self.tasks_done = 0
        self.registered_at = now
        self.task_log: list = []   # (start, end) per task; trace mode only
        self.cache = None          # ExecutorCache when a DataLayer is attached
        self.local_q: deque = deque()   # affinity queue (data-aware dispatch)
        self.local_work = 0.0      # sum of parked tasks' sim durations
        self.in_idle = False       # a live entry exists in the idle deque


class FalkonService:
    """The Falkon execution service: multi-level scheduling (paper §4).

    Provisioning (DRP) is decoupled from dispatch; executors register with
    the service and queued tasks are dispatched to idle executors in O(1).
    Wrap in a `FalkonProvider` to register it as an engine site.

    Example — simulated pool (deterministic, virtual time)::

        clock = SimClock()
        svc = FalkonService(clock, FalkonConfig(
            drp=DRPConfig(max_executors=64, alloc_latency=5.0)))
        eng = Engine(clock)
        eng.add_site("pod0", FalkonProvider(svc), capacity=64)

    Real execution (DESIGN.md §10): pass ``pool=ThreadExecutorPool(clock)``
    (or a `ProcessExecutorPool`) and a `RealClock` — the same program then
    runs task bodies on actual workers, DRP provisioning acquires/releases
    real threads (the pool autoscales with the executor count), and staging
    through an attached data layer performs measured byte copies instead of
    priced ones.  ``pool=DeviceExecutorPool(clock)`` (DESIGN.md §11) keeps
    the same seam but fuses same-signature tasks into one vmapped device
    call per bundle; it is fixed-size (``autoscale`` False), so DRP still
    sizes only the logical executor set.
    """

    def __init__(self, clock: Clock, config: FalkonConfig | None = None,
                 name: str = "falkon", trace: bool = False,
                 data_layer=None, pool=None, tracer=None):
        self.clock = clock
        self.cfg = config or FalkonConfig()
        self.name = name
        self.trace = trace
        # observability (DESIGN.md §12): component events (DRP allocations,
        # affinity parks) are recorded whenever a tracer is attached; the
        # raw series + per-executor task logs additionally require
        # ``trace=True`` and are bounded by the tracer's log caps
        if tracer is None and trace:
            tracer = Tracer()
        self.tracer = tracer
        # data diffusion (DESIGN.md §7): when a DataLayer is attached, tasks
        # with declared inputs prefer idle executors already caching them and
        # input reads are priced by the staging cost model.  None keeps the
        # locality-blind O(1) dispatch path byte-for-byte.
        self.data_layer = data_layer
        # real execution (DESIGN.md §10): when a worker pool is attached,
        # task bodies run on its workers and completions re-enter through
        # the clock's post queue; None keeps the simulated path byte-for-byte
        self.pool = pool
        # online health (DESIGN.md §13): set by `HealthMonitor.watch_service`
        # — per-executor completions feed its windows and its site drain
        # calls `drain_queued`.  None keeps `_complete` to one attribute test.
        self.health = None
        self.queue: deque = deque()
        self.executors: list[Executor] = []
        self._idle: deque = deque()   # O(1) dispatch: idle-executor pool
        self._next_eid = 0
        self._allocating = 0
        self._last_shrink_scan = float("-inf")
        self._dispatcher_free_at = 0.0   # serialize_dispatch gate
        self._parked = 0   # tasks waiting in executor affinity queues
        # metrics — bounded summaries always on; raw logs only under trace
        self.peak_queue = 0
        self.dispatched = 0
        self.tasks_finished = 0
        self.queue_stat = StreamStat(cap=512)   # queue length per pump
        self.alloc_stat = StreamStat(cap=256)   # executors per allocation
        if trace:
            self.queue_len_log = tracer.log(f"{name}.queue_len")
            self.alloc_log = tracer.log(f"{name}.allocs")
        else:
            self.queue_len_log: list = []
            self.alloc_log: list = []

    # ------------------------------------------------------------------
    # resource provisioning (DRP)
    # ------------------------------------------------------------------
    def provision(self, n: int):
        """Explicitly acquire n executors (paying allocation latency once)."""
        self._allocate(n)

    def _allocate(self, n: int):
        n = min(n, self.cfg.drp.max_executors - len(self.executors)
                - self._allocating)
        if n <= 0:
            return
        self._allocating += n
        now = self.clock.now()
        self.alloc_stat.observe(now, n)
        if self.trace:
            self.alloc_log.append((now, n))
        if self.tracer is not None:
            self.tracer.event("drp_alloc", now, n)

        def arrive():
            self._allocating -= n
            for _ in range(n):
                e = Executor(self._next_eid, f"{self.name}-host{self._next_eid}",
                             self.clock.now())
                if self.trace:
                    # bounded Fig-18 per-executor timeline (DESIGN.md §12)
                    e.task_log = BoundedLog(self.tracer.log_cap)
                self._next_eid += 1
                if self.data_layer is not None:
                    self.data_layer.register_executor(e)
                self.executors.append(e)
                self._push_idle(e)
            if self.pool is not None and self.pool.autoscale:
                # real execution: provisioning acquires actual workers —
                # one pool worker per registered executor
                self.pool.resize(len(self.executors))
            self._pump()

        self.clock.schedule(self.cfg.drp.alloc_latency, arrive)

    def _maybe_grow(self):
        d = self.cfg.drp
        have = len(self.executors) + self._allocating
        if have >= d.max_executors:
            return
        # parked affinity-queue tasks are backlog too: they wait for
        # specific holders, but a larger pool gives spillover somewhere
        # to replicate
        backlog = len(self.queue) + self._parked
        if backlog > d.queue_per_executor * max(1, have) or have == 0:
            want = min(d.alloc_chunk, backlog - have + 1)
            self._allocate(max(1, want))

    def _maybe_shrink(self):
        d = self.cfg.drp
        # amortized O(1): nothing can be idle past the timeout while the
        # queue is non-empty, and a full pool scan at most once per half
        # timeout — the seed scanned every executor on every completion,
        # making per-task cost O(pool size).  Parked affinity-queue tasks
        # run only on their (busy) holder, which the per-executor
        # `local_q` check below protects — other idle executors may still
        # be released.
        if self.queue or len(self.executors) <= d.min_executors:
            return
        now = self.clock.now()
        if now - self._last_shrink_scan < d.idle_timeout * 0.5:
            return
        self._last_shrink_scan = now
        drop = set()
        for e in self.executors:
            if (not e.busy and not e.local_q
                    and len(self.executors) - len(drop) > d.min_executors
                    and now - e.idle_since > d.idle_timeout):
                drop.add(e.id)  # de-register (paper: idle auto-deregistration)
        if drop:
            if self.data_layer is not None:
                for e in self.executors:
                    if e.id in drop:
                        self.data_layer.deregister_executor(e)
            self.executors = [e for e in self.executors if e.id not in drop]
            self._idle = deque(e for e in self._idle if e.id not in drop)
            if self.pool is not None and self.pool.autoscale:
                # idle de-registration releases the backing workers too
                self.pool.resize(len(self.executors))

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def submit(self, task, when_done: Callable):
        task._falkon_done = when_done
        task.submit_time = self.clock.now()
        self.queue.append(task)
        if len(self.queue) > self.peak_queue:
            self.peak_queue = len(self.queue)
        self._maybe_grow()
        self._pump()

    def _push_idle(self, e: Executor) -> None:
        """Add to the idle pool unless a live entry already exists — an
        executor claimed off-deque (cache-aware dispatch) keeps its old
        entry as the marker, so the deque never exceeds the pool size."""
        if not e.in_idle:
            e.in_idle = True
            self._idle.append(e)

    def _idle_executor(self) -> Optional[Executor]:
        idle = self._idle
        if not idle:
            return None
        # fast path: head of the pool is usable (the overwhelmingly common
        # case — suspensions and stale entries are failure-path artifacts)
        e = idle[0]
        if not e.busy and self.clock.now() >= e.suspended_until:
            idle.popleft()
            e.in_idle = False
            return e
        now = self.clock.now()
        skipped = []
        found = None
        while self._idle:
            e = self._idle.popleft()
            e.in_idle = False
            if e.busy:
                continue  # stale entry
            if now < e.suspended_until:
                skipped.append(e)  # suspended: back of the pool
                continue
            found = e
            break
        for s in skipped:
            s.in_idle = True
        self._idle.extend(skipped)
        if found is None and skipped:
            # everyone suspended: retry when the first suspension lapses
            wake = min(e.suspended_until for e in skipped)
            self.clock.schedule(max(0.0, wake - now) + 1e-9, self._pump)
        return found

    def _pump(self):
        queue = self.queue
        self.queue_stat.observe(self.clock.now(), len(queue))
        if self.trace:
            self.queue_len_log.append((self.clock.now(), len(queue)))
        dl = self.data_layer
        if dl is None:
            while queue:
                e = self._idle_executor()
                if e is None:
                    break
                task = queue.popleft()
                self._dispatch(e, task)
            return
        # cache-aware dispatch (DESIGN.md §7): each task is routed once —
        # to an idle holder of its inputs (run now), behind a busy holder
        # (its affinity queue, drained at that executor's next completion),
        # or to first-idle as cold spillover.  A task moved to an affinity
        # queue never returns to the global queue, so routing is amortized
        # O(1) per task.  Idle holders are claimed without removing their
        # idle-deque entry — the entry goes stale and the existing
        # busy-skip in `_idle_executor` drops it.
        now = self.clock.now()
        while queue:
            task = queue[0]
            if task.inputs:
                e, run_now = dl.pick_home(task, now)
                if e is not None and not run_now:
                    queue.popleft()
                    e.local_q.append(task)   # wait behind the busy holder
                    e.local_work += sim_duration(task)
                    self._parked += 1
                    if self.tracer is not None:
                        self.tracer.event("affinity_park", now)
                    continue
            else:
                e = None
            if e is None:
                e = self._idle_executor()
                if e is None:
                    break
            queue.popleft()
            self._dispatch(e, task)

    def _dispatch(self, e: Executor, task):
        e.busy = True
        self.dispatched += 1
        overhead = self.cfg.dispatch_overhead
        if self.cfg.serialize_dispatch:
            # the dispatcher is a serial resource (paper §4: 487 tasks/s is
            # a dispatcher ceiling): this task waits for the dispatcher to
            # free, then occupies it for one dispatch_overhead
            now = self.clock.now()
            gate = self._dispatcher_free_at
            wait = gate - now if gate > now else 0.0
            self._dispatcher_free_at = now + wait + overhead
            overhead = wait + overhead
        if self.pool is not None:
            self._dispatch_real(e, task, overhead)
            return
        dl = self.data_layer
        # input staging: cached inputs are read locally, the rest staged
        # from the shared store (and cached for the next task); the I/O time
        # extends the task's service time on this executor
        io = (dl.stage_inputs(e, task, self.clock)
              if dl is not None and task.inputs else 0.0)
        if io:
            sp = getattr(task, "span", None)
            if sp is not None:
                sp.io_s = io      # stage-wait lands on the lifecycle span
        start = self.clock.now() + overhead
        task.start_time = start
        task.host = e.host
        chk = task.fault_check
        if chk is not None and getattr(chk, "timed", False):
            # fail-slow faults (DESIGN.md §13): the injector carries rules
            # whose failures have their own latency (hang/timeout style),
            # so the check runs at dispatch — a hit occupies the executor
            # for the *fault's* duration, not the task's
            fault = None
            try:
                chk(task)
            except BaseException as f:  # noqa: BLE001
                fault = f
            if fault is not None:
                dur = getattr(fault, "latency", None)
                if dur is None:
                    dur = sim_duration(task)
                self.clock.schedule(
                    overhead + io + dur,
                    lambda: self._complete(e, task, False, None, fault,
                                           start))
                return

            def finish():
                # the dispatch-time draw already passed: mask the check so
                # completion doesn't draw (and possibly fail) a second time
                task.fault_check = None
                ok, value, err = execute_task(task)
                task.fault_check = chk
                self._complete(e, task, ok, value, err, start)
        else:
            def finish():
                ok, value, err = execute_task(task)
                self._complete(e, task, ok, value, err, start)

        self.clock.schedule(overhead + io + sim_duration(task), finish)

    def _dispatch_real(self, e: Executor, task, overhead: float):
        """Real execution (DESIGN.md §10): the task body — and, with a data
        layer attached, its real staging copies — runs on a pool worker; the
        measured completion re-enters on the clock thread.  The modeled
        `dispatch_overhead` applies only under ``serialize_dispatch`` (where
        it *is* the model being studied — the dispatcher ceiling); otherwise
        dispatch cost is whatever the dispatcher actually takes."""
        dl = self.data_layer
        stage = None
        if dl is not None and task.inputs:
            # cache/holder bookkeeping happens here on the clock thread;
            # only the byte copies run on the worker (inside the measured
            # service time, where the simulated path adds priced I/O)
            stage = dl.plan_staging(e, task)

        def finish_real(ok, value, err, io_s, run_s):
            if stage is not None:
                dl.end_staging(stage, io_s, self.clock.now())
            if io_s:
                sp = getattr(task, "span", None)
                if sp is not None:
                    sp.io_s = io_s    # measured stage-wait onto the span
            self._complete(e, task, ok, value, err, task.start_time,
                           busy_s=io_s + run_s)

        def handoff():
            task.start_time = self.clock.now()
            task.host = e.host
            self.pool.submit(task, finish_real, stage)

        if self.cfg.serialize_dispatch and overhead > 0.0:
            self.clock.schedule(overhead, handoff)
        else:
            handoff()

    def _complete(self, e: Executor, task, ok: bool, value, err,
                  start: float, busy_s: float | None = None):
        """Shared post-execution bookkeeping for both paths.  `busy_s` is
        the measured service time on the real path; the simulated path
        derives it from the scheduled start/end."""
        end = self.clock.now()
        if self.trace:
            e.task_log.append((start, end))
            self.tracer.exec_span(self.name, e.host, start, end, task.name)
        dl = self.data_layer
        if dl is not None and task.inputs:
            dl.release_inputs(e, task)
        self.tasks_finished += 1
        e.busy = False
        e.idle_since = end
        e.busy_time += busy_s if busy_s is not None else max(0.0, end - start)
        if ok:
            e.consec_failures = 0
            e.tasks_done += 1
        else:
            e.consec_failures += 1
            if e.consec_failures >= self.cfg.host_fail_threshold:
                # paper §3.12: suspend faulty host, reschedule elsewhere
                e.suspended_until = end + self.cfg.host_suspend_time
                e.consec_failures = 0
        if self.health is not None:
            # per-executor windowed error rates (DESIGN.md §13); the
            # monitor may extend `suspended_until` beyond the
            # consecutive-failure heuristic above
            self.health.on_executor(self, e, ok, end)
        next_local = None
        if e.local_q and end < e.suspended_until:
            # suspended host: hand its affinity queue back to the
            # service so other holders (or cold spillover) take it
            self._parked -= len(e.local_q)
            self.queue.extendleft(reversed(e.local_q))
            e.local_q.clear()
            e.local_work = 0.0
        elif e.local_q:
            next_local = e.local_q.popleft()
            e.local_work -= sim_duration(next_local)
            self._parked -= 1
        if next_local is None:
            self._push_idle(e)
        # break the task -> callback -> task reference cycle so
        # completed tasks are freed by refcounting, not the cycle GC
        callback = task._falkon_done
        task._falkon_done = None
        if next_local is not None:
            # affinity queue drains first: the executor keeps running
            # tasks whose inputs it already holds (data diffusion)
            self._dispatch(e, next_local)
        callback(ok, value, err)
        self._maybe_shrink()
        self._pump()

    def drain_queued(self) -> int:
        """Revoke every queued-but-not-running task (global queue plus
        executor affinity queues) back to its submitter with
        ``TaskFailure(kind="revoked")`` — the engine re-places revoked
        tasks on other sites without charging retries (DESIGN.md §13).
        Tasks already running on executors finish (or fail) normally.
        Called by the `HealthMonitor` when it drains this service's site;
        returns the number of tasks revoked."""
        out = list(self.queue)
        self.queue.clear()
        for e in self.executors:
            if e.local_q:
                self._parked -= len(e.local_q)
                out.extend(e.local_q)
                e.local_q.clear()
                e.local_work = 0.0
        for task in out:
            callback = task._falkon_done
            task._falkon_done = None
            callback(False, None,
                     TaskFailure(f"{self.name} drained", kind="revoked"))
        return len(out)

    def shutdown(self) -> None:
        """Stop the attached worker pool, if any (no-op on the simulated
        path).  Call after `run()` returns; queued work has completed."""
        if self.pool is not None:
            self.pool.shutdown()

    # ------------------------------------------------------------------
    def utilization(self) -> dict:
        now = self.clock.now()
        total_busy = sum(e.busy_time for e in self.executors)
        total_alive = sum(now - e.registered_at for e in self.executors)
        return {
            "executors": len(self.executors),
            "dispatched": self.dispatched,
            "peak_queue": self.peak_queue,
            "busy_time": total_busy,
            "alive_time": total_alive,
            "efficiency": total_busy / total_alive if total_alive else 0.0,
        }

    def metrics(self) -> dict:
        """Bounded metrics snapshot — safe at any task count."""
        m = {
            "dispatched": self.dispatched,
            "finished": self.tasks_finished,
            "peak_queue": self.peak_queue,
            "queue": self.queue_stat.summary(),
            "allocations": self.alloc_stat.count,
            "executors_acquired": self.alloc_stat.total,
            "executors": len(self.executors),
        }
        if self.data_layer is not None:
            m["parked"] = self._parked
            m["data"] = self.data_layer.metrics()
        if self.pool is not None and hasattr(self.pool, "metrics"):
            # real path: surface the pool's measured io/run/bundle stats
            # (e.g. DeviceExecutorPool's device_s / bundle_size summaries)
            m["pool"] = self.pool.metrics()
        return m
