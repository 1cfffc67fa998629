"""Single-assignment data futures (Karajan §3.9).

A `DataFuture` is a placeholder resolved exactly once; consumers register
callbacks instead of blocking threads — Karajan's lightweight-thread model.
The deliberately small footprint is measured by benchmarks/scalability.py
(paper Fig 9: ~800 B/thread Karajan, ~3.2 KB/node Swift).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

_ids = itertools.count()


class FutureError(Exception):
    pass


class DataFuture:
    """Single-assignment future: set exactly once, consumed via callbacks.

    The engine's dataflow edges are these — a task's output is a
    `DataFuture`, and downstream tasks list it in their `args` to declare
    the dependency.  No thread ever blocks: `on_done` registers a callback
    (fired immediately if already resolved), `get()` reads a resolved
    value or raises the stored error.

    Example::

        f = DataFuture(name="x")
        f.on_done(lambda fut: print("got", fut.get()))
        f.set(42)                      # fires the callback
        assert f.resolved and f.get() == 42
    """

    # __weakref__ so lifetime contracts (DESIGN.md §9: resolved frontiers
    # are GC-able) can be observed without retaining the future.  "path" is
    # the critical-path length up to this future (DESIGN.md §12) — always
    # initialized so the traced engine reads it as a plain attribute on
    # its hot path; only meaningful when a tracer stamps it at completion
    __slots__ = ("id", "name", "_value", "_error", "_state", "_callbacks",
                 "path", "__weakref__")

    PENDING, RESOLVED, FAILED = 0, 1, 2

    def __init__(self, name: str = ""):
        self.id = next(_ids)
        self.name = name
        self._value: Any = None
        self._error: BaseException | None = None
        self._state = self.PENDING
        self.path = 0.0
        # callback storage is shape-polymorphic to keep the per-future
        # footprint small at 10^6-future scale (DESIGN.md §9): None (no
        # callbacks, the transient majority), a bare callable (exactly one
        # — the dataflow-chain common case), or a list (fan-out)
        self._callbacks: Any = None

    @property
    def resolved(self) -> bool:
        return self._state == self.RESOLVED

    @property
    def failed(self) -> bool:
        return self._state == self.FAILED

    @property
    def done(self) -> bool:
        return self._state != self.PENDING

    def _fire(self) -> None:
        """Detach and invoke the registered callbacks (shape-polymorphic:
        None / bare callable / list — must mirror `on_done`)."""
        cbs, self._callbacks = self._callbacks, None
        if cbs is not None:
            if type(cbs) is list:
                for cb in cbs:
                    cb(self)
            else:
                cbs(self)

    def set(self, value: Any) -> None:
        if self._state != self.PENDING:
            raise FutureError(f"future {self.name or self.id} already set")
        self._value = value
        self._state = self.RESOLVED
        self._fire()

    def set_error(self, err: BaseException) -> None:
        if self._state != self.PENDING:
            raise FutureError(f"future {self.name or self.id} already set")
        self._error = err
        self._state = self.FAILED
        self._fire()

    def get(self) -> Any:
        if self._state == self.RESOLVED:
            return self._value
        if self._state == self.FAILED:
            raise self._error
        raise FutureError(f"future {self.name or self.id} not resolved")

    def on_done(self, cb: Callable[["DataFuture"], None]) -> None:
        if self._state != self.PENDING:
            cb(self)
        elif self._callbacks is None:
            self._callbacks = cb
        elif type(self._callbacks) is list:
            self._callbacks.append(cb)
        else:
            self._callbacks = [self._callbacks, cb]

    def __repr__(self):
        st = {0: "pending", 1: "resolved", 2: "failed"}[self._state]
        return f"<Future {self.name or self.id} {st}>"


def resolved(value: Any, name: str = "") -> DataFuture:
    """A future already resolved to `value` — lifts a literal into the
    dataflow graph (e.g. ``wf.foreach(resolved([1, 2, 3]), body)``)."""
    f = DataFuture(name)
    f.set(value)
    return f


class CompletionCounter:
    """Counting completion sink (DESIGN.md §9).

    Observes futures without retaining references to them: `add` registers
    a bound-method callback on the future and keeps only counters — once a
    future resolves it is reachable solely through whoever else holds it,
    so resolved frontiers are GC-able even when millions of futures flow
    through one counter.  This is what `when_all` and windowed `foreach`
    expansion are built on.

    `on_each(future)` fires at each completion (the caller reads the value
    and drops the reference); `close(on_drain)` declares that no more
    futures will be added — `on_drain` fires once the completion count
    catches up with the add count (immediately if it already has).  The
    first failure's error is retained in `first_error`.
    """

    __slots__ = ("added", "done", "failed", "first_error", "_on_each",
                 "_drain_cb", "_closed")

    def __init__(self, on_each: Callable[[DataFuture], None] | None = None):
        self.added = 0
        self.done = 0
        self.failed = 0
        self.first_error: BaseException | None = None
        self._on_each = on_each
        self._drain_cb: Callable[[], None] | None = None
        self._closed = False

    @property
    def pending(self) -> int:
        return self.added - self.done

    def add(self, fut: DataFuture) -> None:
        self.added += 1
        fut.on_done(self._one)

    def _one(self, f: DataFuture) -> None:
        self.done += 1
        if f.failed:
            self.failed += 1
            if self.first_error is None:
                self.first_error = f._error
        if self._on_each is not None:
            self._on_each(f)
        if self._closed and self.done == self.added:
            cb, self._drain_cb = self._drain_cb, None
            if cb is not None:
                cb()

    def close(self, on_drain: Callable[[], None]) -> None:
        self._closed = True
        if self.done == self.added:
            on_drain()
        else:
            self._drain_cb = on_drain


def when_all(futures, cb: Callable[[], None]) -> None:
    """Invoke cb once every future is done (resolved or failed).

    Accepts any iterable; consumes it once and holds no references to the
    futures (only counters — see `CompletionCounter`), so the caller's own
    lifetime management decides when resolved futures are freed.
    """
    counter = CompletionCounter()
    for f in futures:
        counter.add(f)
    counter.close(cb)
