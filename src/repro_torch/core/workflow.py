"""SwiftScript-style workflow DSL (paper §3.1-3.7), embedded in Python.

* atomic procedures    — typed interfaces to callables (paper lines 7-12)
* compound procedures  — plain Python composition over futures (lines 13-25)
* foreach              — *dynamic* parallel iteration: the collection may be
  a future or a mapped Dataset whose members are only known at runtime
  (paper §3.6, the Montage overlap table) — expansion happens on resolution.
  `window=` switches to streaming expansion (DESIGN.md §9): a bounded
  frontier refilled as body futures resolve, throttled by the engine's
  submit-side backpressure; `reduce=`/`keep_results=False` fold results
  instead of retaining them
* when                 — conditional execution on runtime data
* then                 — continuation on a future's value (monadic bind);
  the building block for deferring pipeline stages to resolution time

Implicit parallelism: procedures return futures immediately; data
dependencies alone order execution (pipelining, §3.13).

The DSL is engine-shape-agnostic: a `Workflow` binds to anything exposing
the engine submission surface (`submit(...)` returning a `DataFuture`,
`run()`, `clock`) — a single `Engine` or a multi-shard `FederatedEngine`
(DESIGN.md §8).  In particular `foreach` expands at *runtime* through
`engine.submit`, so over a federation each expanded body task is
partitioned to a shard as it is created, and cross-shard data
dependencies are carried by the federation's mailbox proxies with no
change to workflow code.
"""
from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, Callable, Union

from repro_torch.core.datastore import inputs_of
from repro_torch.core.engine import Engine
from repro_torch.core.futures import (CompletionCounter, DataFuture, resolved,
                                when_all)
from repro_torch.core.task import task_key
from repro_torch.core.xdtm import Dataset, Mapper, typecheck

if TYPE_CHECKING:
    from repro_torch.core.federation import FederatedEngine
    AnyEngine = Union[Engine, "FederatedEngine"]


class Procedure:
    """An atomic procedure: a typed, dispatchable interface to a callable.

    `inputs` declares the procedure's file inputs for the data layer
    (DESIGN.md §7): a `DataObject`, an iterable of them, or a callable
    mapping the call arguments to either — so a foreach body can name
    per-item files (`inputs=lambda mol: (archive, mol_file[mol])`).
    """

    def __init__(self, wf: "Workflow", fn: Callable | None, name: str,
                 duration: float | Callable | None = None,
                 app: str | None = None, durable: bool = False,
                 input_types: tuple = (), vmap_key=None, inputs=None):
        self.wf = wf
        self.fn = fn
        self.name = name
        self.duration = duration
        # a workflow opened through the service carries a default app (its
        # tenant id) so every procedure lands in that tenant's ReadyQueue
        # bucket — the unit fair-share schedules over (DESIGN.md §15)
        self.app = app or wf.default_app or name
        self.durable = durable
        self.input_types = input_types
        self.vmap_key = vmap_key
        # materialize non-callable declarations once: a one-shot iterator
        # (generator) would silently yield () on every call after the first
        self.inputs = inputs if inputs is None or callable(inputs) \
            else inputs_of(inputs)

    def __call__(self, *args) -> DataFuture:
        if self.input_types:
            for a, t in zip(args, self.input_types):
                if not isinstance(a, DataFuture) and t is not None:
                    if not typecheck(a, t):
                        raise TypeError(
                            f"{self.name}: argument {a!r} fails type {t}")
        dur = self.duration
        if callable(dur):
            # per-call durations (`duration=lambda mol: cost[mol]`): resolve
            # against the raw call args at submit time.  Futures among the
            # args are passed through unresolved — a duration spec that
            # needs runtime *values* should key on the literal args instead.
            dur = dur(*args)
        inputs = self.inputs
        if inputs is not None and type(inputs) is not tuple:
            inputs = inputs_of(inputs, *args)   # callable spec: map call args
        wf = self.wf
        key = wf.stable_key(self.name, args) \
            if wf.key_prefix is not None else None
        return wf.engine.submit(
            self.name, self.fn, list(args), duration=dur, app=self.app,
            durable=self.durable, key=key, vmap_key=self.vmap_key,
            inputs=inputs)


class Workflow:
    """SwiftScript-style DSL over any engine (paper §3.1–3.7).

    Binds to anything exposing the engine submission surface — a single
    `Engine` or a multi-shard `FederatedEngine` — and provides `atomic`
    procedures, dynamic `foreach`, `then` continuations, `when`
    conditionals, and `gather` joins; all return futures and run when
    `run()` drives the clock.

    Example::

        wf = Workflow("demo", engine)

        @wf.atomic
        def square(x):
            return x * x

        total = wf.gather([square(i) for i in range(10)])
        wf.run()
        assert total.get() == [i * i for i in range(10)]
    """

    def __init__(self, name: str, engine: "AnyEngine",
                 key_prefix: str | None = None,
                 default_app: str | None = None):
        self.name = name
        self.engine = engine
        # resumable handles (DESIGN.md §15): a non-None `key_prefix`
        # namespaces every procedure call with a dataflow-stable key
        # (``prefix + task_key(name, args)``, occurrence-disambiguated),
        # so re-building the same program against a `JobStore`-backed
        # resume view restores durably completed tasks instead of
        # re-running them.  `WorkflowService.open` sets this to
        # ``"<wf_id>::"``; `default_app` tags submissions for per-tenant
        # fair share.
        self.key_prefix = key_prefix
        self.default_app = default_app
        self._occurrences: dict[str, int] = {}

    def stable_key(self, name: str, args) -> str:
        """Dataflow-stable unique key for one procedure call: content
        fingerprint plus an occurrence counter, so two calls with the
        same (name, args) get distinct durable rows while a deterministic
        re-build maps the n-th duplicate to the same key it had before
        the crash."""
        base = self.key_prefix + task_key(name, list(args))
        occ = self._occurrences
        n = occ.get(base)
        if n is None:
            occ[base] = 1
            return base
        occ[base] = n + 1
        return f"{base}~{n}"

    # ------------------------------------------------------------------
    def atomic(self, fn: Callable | None = None, *, name: str | None = None,
               duration: float | None = None, app: str | None = None,
               durable: bool = False, input_types: tuple = (),
               vmap_key=None, inputs=None):
        """Decorator: define an atomic procedure."""

        def wrap(f):
            return Procedure(self, f, name or (f.__name__ if f else "task"),
                             duration=duration, app=app, durable=durable,
                             input_types=input_types, vmap_key=vmap_key,
                             inputs=inputs)

        if fn is not None:
            return wrap(fn)
        return wrap

    def sim_proc(self, name: str, duration: float, app: str | None = None,
                 inputs=None):
        """Procedure with a simulated duration and no body (benchmarks)."""
        return Procedure(self, None, name, duration=duration, app=app,
                         inputs=inputs)

    # ------------------------------------------------------------------
    def foreach(self, collection, body: Callable[[Any], Any],
                name: str = "foreach", window: int | None = None,
                reduce: Callable[[Any, Any], Any] | None = None,
                init: Any = None,
                keep_results: bool | None = None) -> DataFuture:
        """Parallel iteration with runtime expansion (paper §3.4/3.6).

        `collection` may be: a list, a generator, a Dataset (mapper resolved
        lazily at expansion time), or a DataFuture resolving to either.
        `body(item)` runs at expansion time and may submit tasks (returning
        futures); the result future resolves to the list of all body results.
        An exception raised by `body` fails the result future instead of
        escaping into the clock callback that triggered expansion.

        **Windowed (streaming) expansion** (DESIGN.md §9): with ``window=k``
        at most k body items are in flight at once — expansion refills from
        the collection (consumed lazily, so a generator is never
        materialized) as body futures resolve, bounding memory by the
        frontier instead of the graph.  The refill loop additionally keys on
        the engine's submit-side backpressure signal (``engine.saturated()``)
        so the standing frontier tracks pool capacity: while the engine has
        ≥ slack x pool capacity in flight, refills pause (never below one
        outstanding item, so progress is guaranteed).  ``window=None`` (the
        default) is the eager path, behaviorally unchanged.

        **Streaming reduction**: ``reduce=fn`` folds each body result into
        an accumulator (seeded with ``init``) instead of retaining the
        result list; the output future resolves to the final accumulator.
        ``keep_results=False`` without a reducer resolves to the count of
        completed items.  With ``window=``, the fold is applied in
        *completion* order (deterministic under `SimClock`, but only equal
        to the eager member-order fold for commutative/associative
        reducers); eager mode folds in member order.  The first body-future
        failure fails the output (streaming mode stops refilling; in-flight
        items still run to completion).
        """
        if keep_results is None:
            keep_results = reduce is None
        if reduce is not None and keep_results:
            raise ValueError("reduce= implies keep_results=False")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        out = DataFuture(name=name)
        coll_f = collection if isinstance(collection, DataFuture) \
            else resolved(collection)

        def members_of(coll):
            if isinstance(coll, (Dataset, Mapper)):
                return coll.members()           # dynamic mapping (§3.6)
            return coll

        def expand(f: DataFuture):
            if f.failed:
                out.set_error(f._error)
                return
            try:
                members = list(members_of(f.get()))
                results = [body(m) for m in members]
            except Exception as err:  # noqa: BLE001 — fail the future,
                out.set_error(err)        # don't escape the clock callback
                return
            futs = [r for r in results if isinstance(r, DataFuture)]

            def finish():
                bad = [ff for ff in futs if ff.failed]
                if bad:
                    out.set_error(bad[0]._error)
                    return
                vals = (r.get() if isinstance(r, DataFuture) else r
                        for r in results)
                if keep_results:
                    out.set(list(vals))
                elif reduce is not None:
                    acc = init
                    try:
                        for v in vals:          # member order (eager mode)
                            acc = reduce(acc, v)
                    except Exception as err:  # noqa: BLE001 — a raising
                        out.set_error(err)        # reducer fails the future
                        return                    # (like the windowed path)
                    out.set(acc)
                else:
                    out.set(sum(1 for _ in vals))

            when_all(futs, finish)

        def expand_windowed(f: DataFuture):
            if f.failed:
                out.set_error(f._error)
                return
            try:
                items = iter(members_of(f.get()))
            except Exception as err:  # noqa: BLE001
                out.set_error(err)
                return
            st = _WindowState(self.engine, out, body, items, window,
                              reduce, init, keep_results)
            st.refill()

        coll_f.on_done(expand_windowed if window is not None else expand)
        return out

    # ------------------------------------------------------------------
    def then(self, fut, fn: Callable[[Any], Any],
             name: str = "then") -> DataFuture:
        """Continuation: run ``fn(value)`` when `fut` resolves; a future
        returned by `fn` is flattened into the result (monadic bind).

        This is dynamic expansion (§3.6) at task granularity, and the
        building block for *deferred graph construction* (DESIGN.md §9): a
        `foreach` body can submit only its first pipeline stage and grow
        the rest via `then` as stages resolve, so even a deep per-item
        pipeline contributes O(stage) — not O(pipeline) — tasks to the
        standing frontier.  Upstream failure propagates without calling
        `fn`; an exception in `fn` fails the result future.
        """
        out = DataFuture(name=name)
        src = fut if isinstance(fut, DataFuture) else resolved(fut)

        def cont(f: DataFuture):
            if f.failed:
                out.set_error(f._error)
                return
            try:
                res = fn(f._value)
            except Exception as err:  # noqa: BLE001
                out.set_error(err)
                return
            if isinstance(res, DataFuture):
                res.on_done(lambda r: out.set_error(r._error) if r.failed
                            else out.set(r._value))
            else:
                out.set(res)

        src.on_done(cont)
        return out

    # ------------------------------------------------------------------
    def when(self, cond, then_fn: Callable[[], Any],
             else_fn: Callable[[], Any] | None = None,
             name: str = "when") -> DataFuture:
        """Conditional execution on runtime data (paper §3.6, Montage
        sub-region co-add decision).  An exception raised by the taken
        branch fails the result future.  `when` is `then` with a branch
        select: same failure propagation, same future flattening."""
        return self.then(
            cond,
            lambda v: then_fn() if v else (else_fn() if else_fn else None),
            name=name)

    # ------------------------------------------------------------------
    def gather(self, futures, name: str = "gather",
               reduce: Callable[[Any, Any], Any] | None = None,
               init: Any = None,
               keep_results: bool | None = None) -> DataFuture:
        """Join a collection of futures into one.

        Default: resolves to the list of all values (first failure fails
        the join).  Bounded accumulation (DESIGN.md §9): with ``reduce=``
        the values are folded into an accumulator in completion order and
        with ``keep_results=False`` alone the join resolves to a count — in
        both modes `futures` may be any iterable (consumed once, lazily)
        and no reference to the futures or their values is retained, so a
        streaming producer's resolved futures stay GC-able.
        """
        if keep_results is None:
            keep_results = reduce is None
        if reduce is not None and keep_results:
            raise ValueError("reduce= implies keep_results=False")
        out = DataFuture(name=name)

        if keep_results:
            futures = list(futures)

            def finish():
                bad = [f for f in futures if f.failed]
                if bad:
                    out.set_error(bad[0]._error)
                else:
                    out.set([f.get() for f in futures])

            when_all(futures, finish)
            return out

        acc_box = [init]

        def on_each(f: DataFuture):
            if f.failed or out.done or reduce is None:
                return                          # first_error is retained
            try:
                acc_box[0] = reduce(acc_box[0], f._value)
            except Exception as err:  # noqa: BLE001 — a raising reducer
                out.set_error(err)              # fails the join immediately

        counter = CompletionCounter(on_each)

        def drained():
            if out.done:
                return                          # reducer already failed it
            if counter.first_error is not None:
                out.set_error(counter.first_error)
            elif reduce is not None:
                out.set(acc_box[0])
            else:
                out.set(counter.done - counter.failed)

        for f in futures:
            counter.add(f)
        counter.close(drained)
        return out

    def run(self):
        self.engine.run()


class _WindowState:
    """Refill loop for one windowed `foreach` expansion (DESIGN.md §9).

    Holds the iterator, the in-flight count, and the accumulator — never
    the resolved futures (completion callbacks are bound methods; a body
    future that resolves drops its only reference into this state).  The
    standing frontier is at most `window`, shrinking toward one outstanding
    item while the engine reports submit-side saturation.
    """

    __slots__ = ("engine", "out", "body", "items", "window", "reduce",
                 "init", "keep", "outstanding", "submitted", "delivered",
                 "exhausted", "stopped", "acc", "results", "_refilling",
                 "_saturated", "_add_waiter", "_waiting")

    def __init__(self, engine, out, body, items, window, reduce, init, keep):
        self.engine = engine
        self.out = out
        self.body = body
        self.items = items
        self.window = window
        self.reduce = reduce
        self.acc = init
        self.keep = keep
        self.outstanding = 0
        self.submitted = 0
        self.delivered = 0
        self.exhausted = False
        self.stopped = False           # failed: no more refills
        self.results: list | None = [] if keep else None
        self._refilling = False
        # duck-typed backpressure probe: anything exposing the engine
        # submission surface works; `saturated()` / the waiter hook are
        # optional (without them the window alone bounds the frontier and
        # refills ride body completions)
        self._saturated = getattr(engine, "saturated", None)
        self._add_waiter = getattr(engine, "add_backpressure_waiter", None)
        self._waiting = False

    # -- one item ------------------------------------------------------
    def _submit_next(self) -> bool:
        try:
            item = next(self.items)
        except StopIteration:
            self.exhausted = True
            return False
        except Exception as err:  # noqa: BLE001 — lazy collections may
            self._fail(err)           # raise mid-iteration
            return False
        idx = self.submitted
        self.submitted += 1
        if self.results is not None:
            self.results.append(None)          # slot filled at completion
        try:
            res = self.body(item)
        except Exception as err:  # noqa: BLE001
            self._fail(err)
            return False
        if isinstance(res, DataFuture):
            self.outstanding += 1
            res.on_done(self._one_done if self.results is None
                        else lambda f, i=idx: self._one_done(f, i))
        else:
            self._deliver(res, idx)
        return True

    # -- completion ----------------------------------------------------
    def _one_done(self, f: DataFuture, idx: int | None = None) -> None:
        self.outstanding -= 1
        if self.stopped:
            return                     # late completion after a failure
        if f.failed:
            self._fail(f._error)
            return
        self._deliver(f._value, idx)
        self.refill()

    def _deliver(self, value, idx) -> None:
        self.delivered += 1
        if self.results is not None:
            self.results[idx] = value          # member order, like eager
        elif self.reduce is not None:
            try:
                self.acc = self.reduce(self.acc, value)
            except Exception as err:  # noqa: BLE001
                self._fail(err)

    def _fail(self, err: BaseException) -> None:
        if not self.stopped:
            self.stopped = True
            self.items = iter(())      # drop the collection reference
            self.out.set_error(err)

    def _wake(self) -> None:
        self._waiting = False
        self.refill()

    # -- the refill loop -----------------------------------------------
    def refill(self) -> None:
        if self._refilling:
            return                     # re-entrant completion (already-
        self._refilling = True         # resolved body future): outer loop
        try:                           # continues the fill
            while (not self.stopped and not self.exhausted
                   and self.outstanding < self.window):
                if self.outstanding > 0 and self._saturated is not None \
                        and self._saturated():
                    # backpressure: frontier tracks pool capacity.  Park a
                    # waiter so expansion resumes the moment a completion
                    # frees room — without it, a window's worth of body
                    # pipelines moves in lockstep cohorts (refills only at
                    # whole-pipeline completions) and the pool starves
                    # through each cohort's serial phases.
                    if self._add_waiter is not None and not self._waiting:
                        self._waiting = True
                        self._add_waiter(self._wake)
                    break
                if not self._submit_next():
                    break
        finally:
            self._refilling = False
        if self.exhausted and self.outstanding == 0 and not self.stopped:
            self.stopped = True
            if self.results is not None:
                out_val, self.results = self.results, None
            elif self.reduce is not None:
                out_val = self.acc
            else:
                out_val = self.delivered
            self.out.set(out_val)
