"""Real concurrent executor pools behind the provider seam (DESIGN.md §10).

The simulated path prices a task's service time and schedules its completion
on the clock; this module supplies the *real* alternative: task bodies run on
actual OS workers, durations are measured, and completions re-enter the
single-threaded scheduler through `Clock.post_release`.  Both pools expose
one seam:

    submit(task, done, stage=None)   # done(ok, value, err, io_s, run_s)
    resize(n) / size() / shutdown()

and register with `FalkonService(pool=...)` exactly like the simulated
executor pool — DRP provisioning acquires real workers (an allocation
spawns threads, idle shrink retires them) — or back a `WorkerPoolProvider`
(``LocalProvider(clock, n, pool=...)``) directly.

  * `ThreadExecutorPool`  — N daemon worker threads over one shared work
    queue.  Right default: scientific task bodies that release the GIL
    (NumPy/JAX, I/O, subprocesses) and every dispatch-overhead benchmark.
  * `ProcessExecutorPool` — `concurrent.futures.ProcessPoolExecutor`
    behind the same seam, for GIL-bound pure-Python bodies.  Task callables
    and resolved argument values must be picklable; fault checks and
    staging copies run on the clock thread (the child sees only
    ``fn(*args)``).

Threading contract: `submit` is called on the clock thread only; workers
touch nothing but the work queue and `post_release`; `done` and all pool
counters run back on the clock thread.  See DESIGN.md §10.
"""
from __future__ import annotations

import queue
import threading
from functools import partial
from time import perf_counter
from typing import Callable, Optional

from repro_torch.core.metrics import StreamStat
from repro_torch.core.simclock import Clock
from repro_torch.core.task import execute_task

_STOP = object()


def _require_threadsafe_clock(clock: Clock, name: str) -> None:
    """Pools complete through `post_release` from worker threads, and rely
    on `run()` blocking while hold tokens are out — a clock without the
    thread-safe post/hold protocol (e.g. `SimClock`) would race its event
    heap and exit with bodies still on workers, silently losing
    completions.  Fail at construction, not mid-run."""
    if not getattr(clock, "threadsafe_post", False):
        raise ValueError(
            f"pool {name!r} needs a clock with thread-safe post/hold "
            f"(RealClock), got {type(clock).__name__}; simulated runs "
            f"use no pool at all")


class ThreadExecutorPool:
    """Real worker threads behind the provider/Falkon seam.

    Example — the same engine program as the simulated path, on threads::

        clock = RealClock()
        pool = ThreadExecutorPool(clock)          # autoscales with DRP
        svc = FalkonService(clock, cfg, pool=pool)
        eng = Engine(clock)
        eng.add_site("pod0", FalkonProvider(svc), capacity=64)
        ... submit tasks with real callables ...
        eng.run()
        pool.shutdown()

    With ``workers=0`` (default) the pool *autoscales*: a `FalkonService`
    it is attached to resizes it to the executor count on every DRP
    allocation arrival and idle shrink, so provisioning acquires and
    releases actual threads.  Pass ``workers=n`` for a fixed-size pool
    (e.g. behind a `LocalProvider`).

    Measured, not priced: `done` receives the staging time and body runtime
    observed on the worker (`perf_counter` deltas); the pool aggregates
    them in bounded `StreamStat` summaries (`io_stat`, `run_stat`).
    """

    autoscale: bool

    def __init__(self, clock: Clock, workers: int = 0, name: str = "threads",
                 tracer=None):
        _require_threadsafe_clock(clock, name)
        self.clock = clock
        self.name = name
        # observability (DESIGN.md §12): completions emit `worker_task`
        # events (count + measured body seconds); mutated on the clock
        # thread only, like every other pool counter
        self.tracer = tracer
        self.autoscale = workers <= 0
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._threads: list[threading.Thread] = []
        self._alive = 0
        self._lock = threading.Lock()
        self._shutdown = False
        # counters/summaries — mutated on the clock thread only
        self.tasks_run = 0
        self.io_stat = StreamStat(cap=256)    # measured staging s per task
        self.run_stat = StreamStat(cap=256)   # measured body s per task
        if workers > 0:
            self.resize(workers)

    def size(self) -> int:
        with self._lock:
            return self._alive

    def resize(self, n: int) -> None:
        """Grow or shrink to `n` worker threads.  Shrinking is graceful:
        retiring workers finish their current task first."""
        if self._shutdown:
            raise RuntimeError(f"pool {self.name!r} is shut down")
        n = max(0, n)
        with self._lock:
            grow = n - self._alive
            self._alive = n
        # drop threads already retired by earlier shrinks, so the roster
        # stays bounded by the live count under autoscale churn
        self._threads = [t for t in self._threads if t.is_alive()]
        for _ in range(max(0, grow)):
            t = threading.Thread(target=self._loop,
                                 name=f"{self.name}-worker", daemon=True)
            self._threads.append(t)
            t.start()
        for _ in range(max(0, -grow)):
            self._q.put(_STOP)

    # -- the seam (clock thread) ----------------------------------------
    def submit(self, task, done: Callable,
               stage: Optional[Callable[[], None]] = None) -> None:
        """Hand one task to the workers.  `stage` (optional) performs the
        real input-staging copies; it runs on the worker, inside the task's
        service time, exactly where the simulated path adds priced staging
        I/O — the pool times it and reports the seconds as `io_s`.
        `done(ok, value, err, io_s, run_s)` is called back on the clock
        thread."""
        self.clock.hold()
        self._q.put((task, stage, done))

    def shutdown(self, wait: bool = True) -> None:
        """Stop all workers (after their queued work) and join them."""
        if self._shutdown:
            return
        self._shutdown = True
        with self._lock:
            alive, self._alive = self._alive, 0
        for _ in range(alive):
            self._q.put(_STOP)
        if wait:
            for t in self._threads:
                t.join()
        self._threads.clear()

    # -- worker side -----------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            task, stage, done = item
            t0 = perf_counter()
            if stage is not None:
                try:
                    stage()
                except BaseException as err:  # noqa: BLE001 — staging
                    t1 = perf_counter()           # failure fails the task
                    self.clock.post_release(partial(
                        self._complete, done, False, None, err, t1 - t0, 0.0))
                    continue
            t1 = perf_counter()
            ok, value, err = execute_task(task)
            t2 = perf_counter()
            self.clock.post_release(partial(
                self._complete, done, ok, value, err, t1 - t0, t2 - t1))

    # -- back on the clock thread ----------------------------------------
    def _complete(self, done, ok, value, err, io_s, run_s) -> None:
        self.tasks_run += 1
        now = self.clock.now()
        self.io_stat.observe(now, io_s)
        self.run_stat.observe(now, run_s)
        if self.tracer is not None:
            self.tracer.event("worker_task", now, run_s)
            if not ok:
                # worker-level failure signal (DESIGN.md §13): the health
                # monitor's event subscription sees pool errors even before
                # the engine's completion path classifies them
                self.tracer.event("worker_error", now)
        done(ok, value, err, io_s, run_s)

    def metrics(self) -> dict:
        """Bounded snapshot — safe at any task count."""
        return {
            "workers": self.size(),
            "tasks_run": self.tasks_run,
            "io_s": self.io_stat.summary(),
            "run_s": self.run_stat.summary(),
        }

    def stats_snapshot(self) -> dict:
        """Picklable measured-stat state (DESIGN.md §14): a shard process
        ships this back at shutdown and the parent folds it into one
        federation-wide view via `StreamStat.merge`."""
        return {
            "tasks_run": self.tasks_run,
            "io_s": self.io_stat.snapshot(),
            "run_s": self.run_stat.snapshot(),
        }


def _run_remote(fn, args):
    """Child-process task body (module-level so it pickles)."""
    return fn(*args)


class ProcessExecutorPool:
    """`ProcessPoolExecutor` behind the same seam as `ThreadExecutorPool`,
    for GIL-bound pure-Python task bodies.

    Example::

        pool = ProcessExecutorPool(clock, workers=4)
        svc = FalkonService(clock, cfg, pool=pool)

    Differences from the thread pool (all documented in DESIGN.md §10):
    the task callable and its *resolved* argument values cross a pickle
    boundary; fault checks run on the clock thread before dispatch; the
    `stage` closure (real staging copies) also runs on the clock thread —
    shipping cache bytes to a child and back would measure pickling, not
    staging.  Pure-sim tasks (no callable) complete without touching the
    process pool at all.  The pool is fixed-size (`autoscale` is False):
    spawning workers per DRP allocation would dominate any measurement.

    Workers start via the ``"spawn"`` method by default: the parent is
    multi-threaded by construction (worker pools, JAX runtimes), and
    forking a multi-threaded process can deadlock the child.  Pass
    ``mp_context="fork"`` only when the parent is known thread-free.
    """

    autoscale = False

    def __init__(self, clock: Clock, workers: int, name: str = "processes",
                 mp_context: str = "spawn", tracer=None):
        if workers < 1:
            raise ValueError("ProcessExecutorPool needs >= 1 worker")
        _require_threadsafe_clock(clock, name)
        self.clock = clock
        self.name = name
        self.tracer = tracer
        self.workers = workers
        self.mp_context = mp_context
        self._exe = None
        self._shutdown = False
        self.tasks_run = 0
        self.io_stat = StreamStat(cap=256)
        self.run_stat = StreamStat(cap=256)

    def size(self) -> int:
        return self.workers

    def resize(self, n: int) -> None:
        """Fixed-size by design; resize requests are ignored (the service
        calls this only for `autoscale` pools)."""

    def _executor(self):
        if self._exe is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            self._exe = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context(self.mp_context))
        return self._exe

    # -- the seam (clock thread) ----------------------------------------
    def submit(self, task, done: Callable,
               stage: Optional[Callable[[], None]] = None) -> None:
        if self._shutdown:
            raise RuntimeError(f"pool {self.name!r} is shut down")
        t0 = perf_counter()
        if stage is not None:
            try:
                stage()
            except BaseException as err:  # noqa: BLE001
                io_s = perf_counter() - t0
                self.clock.schedule(0.0, partial(
                    self._complete, done, False, None, err, io_s, 0.0))
                return
        io_s = perf_counter() - t0
        chk = getattr(task, "fault_check", None)
        if chk is not None:
            try:
                chk(task)
            except BaseException as err:  # noqa: BLE001
                self.clock.schedule(0.0, partial(
                    self._complete, done, False, None, err, io_s, 0.0))
                return
        fn = getattr(task, "fn", None)
        if fn is None:
            # pure-sim task: nothing to run remotely
            self.clock.schedule(0.0, partial(
                self._complete, done, True,
                getattr(task, "sim_value", None), None, io_s, 0.0))
            return
        try:
            args = [a.get() if hasattr(a, "get") and hasattr(a, "on_done")
                    else a for a in task.args]
            fut = self._executor().submit(_run_remote, fn, args)
        except BaseException as err:  # noqa: BLE001 — unpicklable body etc.
            self.clock.schedule(0.0, partial(
                self._complete, done, False, None, err, io_s, 0.0))
            return
        self.clock.hold()
        t1 = perf_counter()

        def on_future_done(f):              # executor waiter thread
            run_s = perf_counter() - t1
            err = f.exception()
            if err is not None:
                res = (False, None, err)
            else:
                res = (True, f.result(), None)
            self.clock.post_release(partial(
                self._complete, done, *res, io_s, run_s))

        fut.add_done_callback(on_future_done)

    def shutdown(self, wait: bool = True) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        if self._exe is not None:
            self._exe.shutdown(wait=wait)
            self._exe = None

    # -- back on the clock thread ----------------------------------------
    def _complete(self, done, ok, value, err, io_s, run_s) -> None:
        self.tasks_run += 1
        now = self.clock.now()
        self.io_stat.observe(now, io_s)
        self.run_stat.observe(now, run_s)
        if self.tracer is not None:
            self.tracer.event("worker_task", now, run_s)
            if not ok:
                # worker-level failure signal (DESIGN.md §13): the health
                # monitor's event subscription sees pool errors even before
                # the engine's completion path classifies them
                self.tracer.event("worker_error", now)
        done(ok, value, err, io_s, run_s)

    def metrics(self) -> dict:
        """Bounded snapshot — safe at any task count."""
        return {
            "workers": self.workers,
            "tasks_run": self.tasks_run,
            "io_s": self.io_stat.summary(),
            "run_s": self.run_stat.summary(),
        }

    def stats_snapshot(self) -> dict:
        """Picklable measured-stat state (see `ThreadExecutorPool`)."""
        return {
            "tasks_run": self.tasks_run,
            "io_s": self.io_stat.snapshot(),
            "run_s": self.run_stat.snapshot(),
        }
