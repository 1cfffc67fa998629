"""Clock abstraction: real wall-clock or deterministic discrete-event clock.

Engine benchmarks that reproduce the paper's provider comparisons (PBS vs
Falkon, Fig 6/10/11/13/14/17) run on `SimClock` — virtual time, so a
"25,292 second" GRAM/PBS MolDyn run simulates in milliseconds and results are
deterministic.  `RealClock` is the wall-clock event loop behind the real
execution path (DESIGN.md §10): the same engine/provider/Falkon code runs
unchanged, task bodies execute on real worker threads
(`repro_torch.core.realpool`), and completions re-enter the loop through the
thread-safe `post` queue.

Threading contract (DESIGN.md §10): every scheduler object — `Engine`,
`FalkonService`, providers, the data layer — runs entirely on the thread
that called `run()` ("the clock thread").  Worker threads touch only the
pool's work queue and `post`/`post_release`; everything they hand back is
executed on the clock thread.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Callable


class Clock:
    """Abstract scheduler clock: `now`, `schedule(delay, fn)`, `run`.

    Example — run one deferred callback::

        clock = SimClock()
        clock.schedule(5.0, lambda: print(clock.now()))   # prints 5.0
        clock.run()
    """

    def now(self) -> float:
        raise NotImplementedError

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        raise NotImplementedError

    def run(self) -> None:
        """Process events until idle."""
        raise NotImplementedError

    # -- cross-thread hand-off (real execution path, DESIGN.md §10) -----
    # True only on clocks whose `post` may be called from other threads
    # and whose `run` waits for held external work; worker pools require
    # it (a SimClock cannot host real workers — see ThreadExecutorPool)
    threadsafe_post = False

    def post(self, fn: Callable[[], None]) -> None:
        """Enqueue `fn` to run on the clock thread.  The base implementation
        is `schedule(0, fn)` — correct for single-threaded clocks like
        `SimClock`, where "another thread" does not exist but transports
        (e.g. `QueueTransport`) still want one delivery API.  `RealClock`
        overrides this with a thread-safe, loop-waking version."""
        self.schedule(0.0, fn)

    def post_many(self, fns) -> None:
        """Enqueue an ordered batch of callbacks in one operation — the
        bulk form of `post`, used by boundary reader threads (process
        transports, DESIGN.md §14) that drain several messages per
        wakeup.  The base implementation posts one by one; `RealClock`
        overrides it with a single lock acquisition and one loop wakeup
        for the whole batch."""
        for fn in fns:
            self.post(fn)

    def post_release(self, fn: Callable[[], None]) -> None:
        """`post(fn)` plus the release of one `hold()` token, atomically —
        used by worker pools so the loop can never observe "no holds, no
        events" between a completion being enqueued and its token being
        returned."""
        self.post(fn)
        self.release()

    def hold(self) -> None:
        """Take one external-work token: `run()` must not exit while tokens
        are outstanding (a task is on a worker thread and its completion
        has not been posted yet).  No-op on purely event-driven clocks."""

    def release(self) -> None:
        """Return one external-work token (see `hold`)."""


class SimClock(Clock):
    """Deterministic discrete-event clock (virtual time).

    Events fire in (time, insertion) order; `now()` jumps to each event's
    timestamp, so a simulated 7-hour MolDyn campaign runs in milliseconds
    and every run replays identically.

    Example::

        clock = SimClock()
        clock.schedule(3600.0, lambda: None)
        clock.run()
        assert clock.now() == 3600.0      # virtual seconds, instant wall time
    """

    def __init__(self):
        self._now = 0.0
        self._heap: list = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (self._now + max(0.0, delay),
                                    next(self._seq), fn))

    def run(self) -> None:
        heap = self._heap
        pop = heapq.heappop
        while heap:
            t, _, fn = pop(heap)
            if t > self._now:
                self._now = t
            fn()


class RealClock(Clock):
    """Wall-clock event loop with thread-safe wakeups (DESIGN.md §10).

    Single-threaded core, Karajan-style: `schedule(0, fn)` runs via a FIFO
    queue, positive delays wait on a monotonic timer heap.  Two extensions
    make it the spine of the *real* execution path:

      * `post(fn)` / `post_release(fn)` — thread-safe enqueue from worker
        threads (task completions, transport deliveries); the loop wakes
        immediately, even mid-timer-wait.
      * `hold()` / `release()` — external-work tokens: while a task body is
        out on a worker thread there may be no queued event and no timer,
        yet the run is not finished.  `run()` blocks on the condition
        variable instead of exiting while tokens are outstanding.

    Example — same program as `SimClock`, but measured::

        clock = RealClock()
        clock.schedule(0.01, lambda: None)
        clock.run()                        # really waits ~10 ms
        assert clock.now() >= 0.01

    Everything scheduled or posted executes on the thread that called
    `run()`; scheduler state is never touched from worker threads.
    """

    threadsafe_post = True

    def __init__(self):
        self._queue: deque = deque()
        self._heap: list = []
        self._seq = itertools.count()
        self._t0 = time.monotonic()
        self._cond = threading.Condition()
        self._posted: deque = deque()
        self._holds = 0

    def now(self) -> float:
        return time.monotonic() - self._t0

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        if delay <= 0:
            self._queue.append(fn)
        else:
            heapq.heappush(self._heap, (self.now() + delay,
                                        next(self._seq), fn))

    # -- cross-thread hand-off ------------------------------------------
    def post(self, fn: Callable[[], None]) -> None:
        with self._cond:
            self._posted.append(fn)
            self._cond.notify()

    def post_many(self, fns) -> None:
        with self._cond:
            self._posted.extend(fns)
            self._cond.notify()

    def post_release(self, fn: Callable[[], None]) -> None:
        with self._cond:
            self._posted.append(fn)
            self._holds -= 1
            self._cond.notify()

    def hold(self) -> None:
        with self._cond:
            self._holds += 1

    def release(self) -> None:
        with self._cond:
            self._holds -= 1
            self._cond.notify()

    # -------------------------------------------------------------------
    def run(self) -> None:
        queue = self._queue
        heap = self._heap
        cond = self._cond
        posted = self._posted
        while True:
            if posted:
                # drain cross-thread posts into the ordinary FIFO; the lock
                # is only needed around the handoff
                with cond:
                    while posted:
                        queue.append(posted.popleft())
            if queue:
                queue.popleft()()
                continue
            wait = None
            if heap:
                wait = heap[0][0] - self.now()
                if wait <= 0:
                    _, _, fn = heapq.heappop(heap)
                    fn()
                    continue
            with cond:
                if posted:
                    continue
                if wait is None and self._holds == 0:
                    break          # idle: no events, no timers, no workers
                cond.wait(wait)    # timer due, or a post/release will wake us
