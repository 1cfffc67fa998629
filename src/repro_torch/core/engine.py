"""The Karajan-style execution engine (paper §3.8-3.13) — dataflow +
dispatch policy only.

Event-driven, future-based: every task is a lightweight record (no OS
threads); data dependencies are futures; a task becomes *ready* when its
argument futures resolve and is dispatched through a provider picked by the
score-based load balancer.  Pipelining across stages is inherent (§3.13 —
"comes for free with the future mechanism").

The engine is the top of the layered scheduler subsystem (DESIGN.md §1):
task records live in `repro_torch.core.task`, providers in
`repro_torch.core.providers`, the Falkon service in `repro_torch.core.falkon`, and
sites/load-balancing in `repro_torch.core.sites`.  Per-task work here is O(1) in
both task count and site count: site candidates come from the balancer's
per-app index, and the ready queue (`_pending`) is drained in coalesced
batches rather than one scheduled event per completion.

The pre-refactor names (`Task`, `Provider`, `LocalProvider`,
`BatchSchedulerProvider`, `FalkonProvider`, `ClusteringProvider`) are
re-exported so existing imports of `repro_torch.core.engine` keep resolving.
"""
from __future__ import annotations

from collections import deque
from functools import partial

from repro_torch.core.datastore import inputs_of
from repro_torch.core.faults import FaultInjector, RetryPolicy, TaskFailure
from repro_torch.core.futures import DataFuture, when_all
from repro_torch.core.provenance import VDC, InvocationRecord
from repro_torch.core.providers import (BatchSchedulerProvider, ClusteringProvider,
                                  FalkonProvider, LocalProvider, Provider,
                                  WorkerPoolProvider)
from repro_torch.core.restart_log import RestartLog
from repro_torch.core.simclock import Clock, SimClock
from repro_torch.core.sites import LoadBalancer, Site
from repro_torch.core.task import Task, sim_duration, task_key

__all__ = [
    "Engine", "ReadyQueue", "Task", "Provider", "WorkerPoolProvider",
    "LocalProvider", "BatchSchedulerProvider", "FalkonProvider",
    "ClusteringProvider",
]


class ReadyQueue:
    """Held ready tasks, bucketed per app.

    The drain pass visits each app bucket head-first and stops at the
    first unplaceable task, so a blocked app costs O(1) instead of
    shuffling its whole backlog through the deque — with a standing
    backlog of K tasks (a federation shard holding excess work for the
    stealer) the seed's flat deque made every completion O(K).  Buckets
    preserve per-app FIFO; iteration order is app first-arrival order
    (dict insertion), deterministic under `SimClock`.

    `steal(n)` is the work-migration interface (DESIGN.md §8): pops up to
    n entries from the *newest* end, largest bucket first, so the victim
    keeps its oldest work in order and the thief gets work least likely
    to be locality-bound.  O(apps + n) per call.
    """

    __slots__ = ("_buckets", "_len")

    def __init__(self):
        self._buckets: dict = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def append(self, item) -> None:
        app = item[0].app
        bucket = self._buckets.get(app)
        if bucket is None:
            self._buckets[app] = bucket = deque()
        bucket.append(item)
        self._len += 1

    def buckets(self):
        """(app, deque) pairs; snapshot so callers may drop empty buckets."""
        return list(self._buckets.items())

    def pop_head(self, app) -> None:
        """Drop the head of `app`'s bucket (after a successful placement)."""
        bucket = self._buckets[app]
        bucket.popleft()
        self._len -= 1
        if not bucket:
            del self._buckets[app]

    def peek(self, n: int) -> list:
        """Up to n *tasks* from the newest end — what `steal(n)` would
        migrate — largest bucket first, without removing anything.
        O(apps + n); the directory-guided `WorkStealer` samples these to
        price a candidate victim's restage cost before committing to a
        steal (DESIGN.md §14)."""
        out: list = []
        if not self._len:
            return out
        # stable sort: ties keep first-arrival order, matching the
        # max-by-length bucket choice steal() makes
        for app in sorted(self._buckets,
                          key=lambda a: -len(self._buckets[a])):
            bucket = self._buckets[app]
            take = min(len(bucket), n - len(out))
            for i in range(1, take + 1):
                out.append(bucket[-i][0])
            if len(out) >= n:
                break
        return out

    def steal(self, n: int) -> list:
        """Pop up to n entries from the newest end, largest bucket first."""
        out = []
        while len(out) < n and self._len:
            # apps are few (workflow-level); max over the bucket dict is
            # O(apps), ties broken by first-arrival order (deterministic)
            app = max(self._buckets, key=lambda a: len(self._buckets[a]))
            bucket = self._buckets[app]
            take = min(len(bucket), n - len(out))
            for _ in range(take):
                out.append(bucket.pop())
            self._len -= take
            if not bucket:
                del self._buckets[app]
        out.reverse()                  # restore ready order for the thief
        return out


class Engine:
    """The Karajan-style dataflow engine: submit tasks, get futures, run.

    Tasks become *ready* when their argument futures resolve and are placed
    on a site by the score-based `LoadBalancer`; `run()` drives the clock
    until the graph drains.  Most programs use the `Workflow` DSL on top,
    but `submit` is the primitive everything lowers to.

    Example::

        clock = SimClock()                 # or RealClock() for wall time
        eng = Engine(clock)
        eng.local_site(concurrency=4)
        a = eng.submit("double", lambda x: 2 * x, args=[21])
        b = eng.submit("inc", lambda x: x + 1, args=[a])   # depends on a
        eng.run()
        assert b.get() == 43

    Constructor knobs: ``provenance="summary"`` keeps only aggregate VDC
    counters (required at 10^6 tasks), `restart_log`/`fault_injector`
    enable §3.12 behaviors, `retry_policy` bounds retries.
    """

    def __init__(self, clock: Clock | None = None,
                 retry_policy: RetryPolicy | None = None,
                 vdc: VDC | None = None,
                 restart_log: RestartLog | None = None,
                 fault_injector: FaultInjector | None = None,
                 provenance: str = "records",
                 duration_predictor=None,
                 tracer=None):
        self.clock = clock or SimClock()
        # observability (DESIGN.md §12): when a `Tracer` is attached every
        # task gets lifecycle accounting (exact counters + critical path)
        # and every k-th task a full span; None keeps each hook to a
        # single attribute test.
        self.tracer = tracer
        # online health (DESIGN.md §13): set by `HealthMonitor.watch` —
        # dispatch/completion hooks feed its rolling windows and its state
        # machine drives `Site.suspended_until`/`Site.derate`.  None keeps
        # each hook to a single attribute test.
        self.health = None
        self.retry_policy = retry_policy or RetryPolicy()
        self.vdc = vdc or VDC()
        self.restart_log = restart_log
        self.fault_injector = fault_injector
        # durability (DESIGN.md §15): set to a `jobstore.Journal` (usually
        # by `WorkflowService`) to record every task's status transitions
        # through the explicit state machine into the sqlite store.  None
        # keeps each hook to a single attribute test, like tracer/health.
        self.journal = None
        # multi-tenant fair share (DESIGN.md §15): when True, the pending
        # drain interleaves app buckets by stride scheduling (weights from
        # `app_shares`, default 1) instead of first-arrival bucket order,
        # so one app's standing backlog cannot starve later arrivals.
        self.fair_share = False
        self.app_shares: dict = {}
        self._fair_pass: dict = {}
        self._fair_vt = 0.0
        # duration prediction (DESIGN.md §11): when a predictor (e.g.
        # `repro.launch.hlo_cost.DurationPredictor`) is attached, tasks
        # with a callable and no explicit `duration=` are priced from
        # their HLO cost *before* dispatch — the predicted seconds then
        # steer the duration-aware balancer, the data layer's
        # wait-vs-stage test, and anything else reading `sim_duration`.
        # None keeps the submit hot path byte-for-byte.
        self.duration_predictor = duration_predictor
        self.balancer = LoadBalancer([])
        self.tasks_submitted = 0
        self.tasks_completed = 0
        self.tasks_failed = 0
        self.tasks_restored = 0
        self.tasks_revoked = 0   # drain revocations re-placed (§13)
        # per-site submission throttle (Swift holds excess ready tasks and
        # feeds sites as they turn jobs around, letting responsiveness
        # scores steer the split — paper §3.13)
        self.site_slack = 2.0
        self._pending = ReadyQueue()
        self._drain_scheduled = False
        # federation hooks (DESIGN.md §8): set by FederatedEngine.attach.
        # `_hold_excess` keeps ready tasks beyond the site throttle in
        # `_pending` even with a single site, so a WorkStealer has a
        # migratable backlog; the notify hooks are O(1)-guarded calls into
        # the federation on backlog growth / local starvation.  All three
        # are inert (one attribute test per event) outside a federation.
        self.shard_id: int | None = None
        self._federation = None
        self._hold_excess = False
        # submit-side backpressure waiters (DESIGN.md §9): single-shot
        # callbacks fired by `_done` when a completion leaves the engine
        # unsaturated — the streaming-expansion refill loop parks here so
        # the frontier resumes the moment the pool has room, not only when
        # a whole body pipeline completes.  Empty-list check per completion
        # when unused.
        self._bp_waiters: list = []
        # provenance="summary" keeps the VDC aggregate counters but skips
        # per-invocation records — required for bounded-memory 10^6-task runs
        if provenance not in ("records", "summary"):
            raise ValueError(f"provenance must be records|summary, "
                             f"got {provenance!r}")
        self._prov_records = provenance == "records"

    # ------------------------------------------------------------------
    def add_site(self, name: str, provider: Provider, capacity: int = 1,
                 apps: set[str] | None = None, data_layer=None) -> Site:
        site = Site(name, provider, capacity, apps)
        self.balancer.add_site(site)
        if data_layer is not None:
            # cache-aware balancing: pick() will boost this site for tasks
            # whose declared inputs its executors already hold
            self.balancer.set_affinity(name, data_layer)
        return site

    def local_site(self, concurrency: int = 1) -> Site:
        return self.add_site("localhost",
                             LocalProvider(self.clock, concurrency),
                             capacity=concurrency)

    # ------------------------------------------------------------------
    def submit(self, name: str, fn=None, args: list | None = None,
               duration: float | None = None, app: str | None = None,
               durable: bool = False, key: str | None = None,
               vmap_key=None, inputs=None) -> DataFuture:
        """Submit one task; returns its output `DataFuture` immediately.

        `fn` is the task body (None for pure-simulation tasks); `args` may
        mix literals and futures — the task dispatches when every argument
        future resolves.  `duration` is the simulated service time (ignored
        on the real execution path, where runtime is measured).  `app`
        routes via site app-validity; `durable` + a `RestartLog` persists
        the result; `inputs` declares the task's file inputs for the data
        layer — a `DataObject`, an iterable of them, or a callable mapping
        the call args to either (see `DataLayer`, DESIGN.md §7).
        """
        args = args or []
        out = DataFuture(name=name)
        if key is None:
            # dataflow-stable keys are only needed for restart-log lookups
            # and journaling; skip the fingerprint hash on the hot path
            # otherwise, and in summary-provenance mode (no stored records
            # reference the key) skip even the counter suffix
            if self.journal is not None:
                # the store's primary key is (wf, key): duplicate content
                # keys get a deterministic occurrence suffix
                key = self.journal.unique_key(task_key(name, args))
            elif self.restart_log is not None:
                key = task_key(name, args)
            elif self._prov_records:
                key = f"{name}#{self.tasks_submitted}"
            else:
                key = name
        out.name = key

        # restart log: datasets already produced are marked available and
        # their producing tasks are NOT re-run (paper §3.12)
        if self.restart_log is not None:
            hit, value = self.restart_log.lookup(key)
            if hit:
                self.tasks_restored += 1
                out.set(value)
                return out

        # Procedure.__call__ already normalizes to a tuple — trust it and
        # skip re-normalizing on the per-task hot path; a callable spec
        # receives the call args, as on the Procedure path
        if type(inputs) is not tuple:
            inputs = inputs_of(inputs, *args) if inputs is not None else ()
        task = Task(name, fn, args, out, duration, app,
                    self.retry_policy.max_retries, durable, key,
                    inputs=inputs)
        task.created_time = self.clock.now()
        j = self.journal
        if j is not None and j.full:
            # terminal durability records completions only — the
            # non-terminal transitions never leave the clock thread
            j.task_submitted(key)
        task.vmap_key = vmap_key
        tr = self.tracer
        if tr is not None:
            # the sampling decision (Tracer.task_created) is inlined — a
            # counter bump and one modulus for the overwhelming non-sampled
            # majority; ready_t/path0 are stamped in _ready (dependent
            # tasks) or just below (dependency-free tasks), never in
            # Task.__init__, so the tracing-off hot path skips the slots
            tr.tasks_seen = seen = tr.tasks_seen + 1
            task.span = (tr._new_span(task, task.created_time,
                                      self.shard_id)
                         if (seen - 1) % tr._k == 0 else None)
        if self.fault_injector is not None:
            inj = self.fault_injector

            def chk(t):
                s = t.site
                inj.check(t.name, t.host, t.attempt,
                          s.name if s is not None else "")

            if getattr(inj, "timed", False):
                # fail-slow rules: the Falkon sim path pre-evaluates the
                # check at dispatch so TaskFailure.latency can set the
                # failed attempt's service time
                chk.timed = True
            task.fault_check = chk
        self.tasks_submitted += 1
        # dependency scan without per-task garbage: at frontier scale
        # (10^6 in-flight tasks) the list + closure the seed allocated
        # here were ~40% of per-task graph memory; `partial` carries the
        # task reference in one small object instead
        first = None
        nfuts = 0
        for a in args:
            if isinstance(a, DataFuture):
                nfuts += 1
                if first is None:
                    first = a
        if nfuts == 0:
            if tr is not None:
                task.path0 = -task.created_time
            if (duration is None and fn is not None
                    and self.duration_predictor is not None):
                task.duration = self.duration_predictor.predict_duration(
                    fn, args)
            self._dispatch(task)
        elif nfuts == 1:
            # single dependency (serial chains): skip the when_all counter
            first.on_done(partial(self._ready, task))
        else:
            when_all((a for a in args if isinstance(a, DataFuture)),
                     partial(self._ready, task))
        return out

    # -- submit-side backpressure (DESIGN.md §9) -----------------------
    def inflight(self) -> int:
        """Tasks submitted but not yet finished (queued, held, or running)."""
        return self.tasks_submitted - self.tasks_completed - self.tasks_failed

    def ready_backlog(self) -> int:
        """Ready tasks held because every valid site is throttled."""
        return len(self._pending)

    def pool_capacity(self) -> int:
        """Total registered site capacity (executor slots)."""
        return sum(s.capacity for s in self.balancer.sites)

    def dispatchable(self) -> int:
        """Dependency-free work the pool can chew on right now: tasks
        handed to site providers (queued or running) plus the held ready
        backlog.  Dependency-*blocked* tasks are excluded on purpose —
        they occupy memory, not executors."""
        return (sum(s.outstanding for s in self.balancer.sites)
                + len(self._pending))

    def saturated(self, slack: float | None = None) -> bool:
        """Submit-side backpressure (DESIGN.md §9): True while the engine
        already holds at least ``slack x pool capacity`` of *dispatchable*
        work.  Streaming `foreach` expansion keys its refill loop on this,
        so the standing frontier tracks pool capacity rather than a fixed
        window constant — expanding further ahead than this grows the
        graph, never the achieved throughput.  Keyed on dispatchable work,
        not `inflight()`: a pipeline-shaped body contributes mostly
        dependency-blocked tasks, and throttling on those would starve
        the pool long before memory was a concern (the hard memory bound
        is the window itself)."""
        cap = self.pool_capacity()
        if cap <= 0:
            return False
        if slack is None:
            slack = self.site_slack
        return self.dispatchable() >= slack * cap

    def add_backpressure_waiter(self, cb) -> None:
        """Register a single-shot callback fired when a completion leaves
        the engine unsaturated (all waiters fire together)."""
        self._bp_waiters.append(cb)

    def _wake_backpressure(self) -> None:
        if self._bp_waiters and not self.saturated():
            waiters, self._bp_waiters = self._bp_waiters, []
            for cb in waiters:
                cb()

    # ------------------------------------------------------------------
    def _ready(self, task: Task, _f: DataFuture | None = None):
        tr = self.tracer
        if tr is None:
            for a in task.args:
                if isinstance(a, DataFuture) and a.failed:
                    task.output.set_error(
                        TaskFailure(f"upstream failure for {task.name}"))
                    self.tasks_failed += 1
                    if self.journal is not None:
                        self.journal.task_failed(task.key, "upstream failure")
                    task.args = ()
                    return
        else:
            # single pass over the args: the upstream-failure check merged
            # with the O(1)/task critical-path propagation — path up to
            # this task's start is the max over its parents' path values,
            # read here *before* the args are cleared below (DESIGN.md §12)
            p0 = 0.0
            for a in task.args:
                if type(a) is DataFuture:
                    if a.failed:
                        task.output.set_error(
                            TaskFailure(f"upstream failure for {task.name}"))
                        self.tasks_failed += 1
                        tr.task_done(task, self.clock.now(), "failed")
                        if self.journal is not None:
                            self.journal.task_failed(task.key,
                                                     "upstream failure")
                        task.args = ()
                        return
                    p = a.path
                    if p > p0:
                        p0 = p
            now = self.clock.now()
            # path0 encodes (parent path - ready time): completion adds
            # `now` back, so the done-path costs one addition per task
            task.path0 = p0 - now
            sp = task.span
            if sp is not None:
                sp.ready = now
        if task.fn is None and task.vmap_key is None:
            # pure-sim task: the argument values are never read again, so
            # drop them now — in a streaming (windowed) expansion this is
            # what lets a resolved upstream chain be freed while its
            # dependents are still queued (DESIGN.md §9 GC contract)
            task.args = ()
        elif (task.duration is None and task.fn is not None
                and self.duration_predictor is not None):
            # future-fed tasks are priced here, when the argument shapes
            # are known; the predictor's signature cache makes this a
            # dict probe for every task after the first per signature
            task.duration = self.duration_predictor.predict_duration(
                task.fn, [a.get() if isinstance(a, DataFuture) else a
                          for a in task.args])
        self._dispatch(task)

    def _dispatch(self, task: Task, exclude_site: str | None = None):
        j = self.journal
        if j is not None and j.full:
            j.task_ready(task.key)
        if not self._place(task, exclude_site):
            # every valid site is at its throttle: hold in the ready queue
            self._pending.append((task, exclude_site))
            if self._federation is not None:
                self._federation.notify_backlog(self)

    def _place(self, task: Task, exclude_site: str | None = None) -> bool:
        """Try to hand the task to a site; False means *hold* (valid sites
        exist but all are throttled or suspended)."""
        cands = self.balancer.sites_for(task.app)
        if not cands:
            task.output.set_error(TaskFailure(f"no site for {task.name}"))
            self.tasks_failed += 1
            if self.tracer is not None:
                self.tracer.task_done(task, self.clock.now(), "failed")
            if self.journal is not None:
                self.journal.task_failed(task.key, "no site")
            return True  # consumed (failed), not held
        now = self.clock.now()
        # throttle only matters when there is a choice to steer: with a
        # single site the provider's own queue is the right place to wait —
        # unless this engine is a federation shard (`_hold_excess`), where
        # excess ready work stays in `_pending` so it can be stolen, or
        # fair share is on (§15), where the stride drain must own the
        # ordering of everything not yet running
        site = self.balancer.pick(task.app, now,
                                  require_room=(len(cands) > 1
                                                or self._hold_excess
                                                or self.fair_share),
                                  slack=self.site_slack,
                                  inputs=task.inputs or None)
        if site is None:
            return False
        if site.name == exclude_site:
            for s in cands:
                if s.name != exclude_site and now >= s.suspended_until:
                    site = s
                    break
        task.site = site
        task.submit_time = now
        j = self.journal
        if j is not None and j.full:
            j.task_dispatched(task.key)
        site.outstanding += 1
        if self.balancer.duration_aware:
            site.outstanding_work += sim_duration(task)
        site.stats.submitted += 1
        h = self.health
        if h is not None:
            # before provider.submit: a provider may complete synchronously
            # and the monitor must see dispatch before finish (inlined
            # HealthMonitor.task_dispatched — §13 hot-path contract)
            if not h._armed:
                h.arm()
            r = h._running
            if len(r) < h._track_cap:
                r.append(task)
        site.provider.submit(
            task, lambda ok, v, e: self._done(task, ok, v, e))
        return True

    def _drain_pending(self):
        """Batched drain: after completions free capacity, dispatch *every*
        pending task that now has room, in one pass.  The seed engine popped
        a single task per completion, which both cost one clock event per
        task and head-of-line-blocked apps whose site had no room.  The
        per-app buckets make the pass O(apps + placed): an app whose sites
        are full is skipped at its bucket head, its backlog untouched."""
        self._drain_scheduled = False
        pending = self._pending
        if self.fair_share and len(pending._buckets) > 1:
            self._drain_fair(pending)
            return
        for app, bucket in pending.buckets():
            while bucket:
                task, excl = bucket[0]
                if not self._place(task, excl):
                    break              # app blocked; leave its backlog be
                pending.pop_head(app)

    def _drain_fair(self, pending: ReadyQueue):
        """Stride-scheduled drain (DESIGN.md §15): each placement goes to
        the app with the smallest virtual *pass*, which then advances by
        1/share.  Per-app pass values persist across drains, so even when
        completions free one slot at a time the long-run placement ratio
        between backlogged apps converges to their `app_shares` weights —
        the first-arrival bucket order of the default drain would hand
        every freed slot to the oldest app until its backlog drained
        (the starved-app case in `tests/test_service.py`)."""
        passes = self._fair_pass
        shares = self.app_shares
        vt = self._fair_vt
        blocked: set = set()
        buckets = pending._buckets
        while True:
            best = None
            best_pass = 0.0
            for app, bucket in buckets.items():
                if app in blocked or not bucket:
                    continue
                p = passes.get(app)
                if p is None or p < vt:
                    # joining (or rejoining after idle) apps start at the
                    # current virtual time: an idle period banks no credit
                    passes[app] = p = vt
                if best is None or p < best_pass:
                    best, best_pass = app, p
            if best is None:
                break
            task, excl = buckets[best][0]
            if not self._place(task, excl):
                blocked.add(best)
                continue
            pending.pop_head(best)
            vt = best_pass
            passes[best] = best_pass + 1.0 / shares.get(best, 1.0)
        self._fair_vt = vt

    def _done(self, task: Task, ok: bool, value, err):
        site = task.site
        now = self.clock.now()
        site.outstanding -= 1
        if self.balancer.duration_aware:
            # clamp: float drift must never leave a phantom backlog
            site.outstanding_work = max(
                0.0, site.outstanding_work - sim_duration(task))
        if self._pending:
            if not self._drain_scheduled:
                self._drain_scheduled = True
                self.clock.schedule(0.0, self._drain_pending)
        elif self._federation is not None:
            # shard starving: no held backlog left — let the federation's
            # stealer consider migrating work here (flag-guarded, O(1))
            self._federation.notify_idle(self)
        fed = self._federation
        if fed is not None and fed._bp_waiters:
            fed._wake_backpressure()
        if self._bp_waiters:
            # not elif: a workflow driven over one *shard* of a federation
            # registers its waiters here, and they must still fire
            self._wake_backpressure()
        if ok:
            site.on_success(now - task.submit_time)
            self.tasks_completed += 1
            h = self.health
            if h is not None:
                # inlined HealthMonitor.task_finished (§13 hot-path
                # contract): error windows come from Site.stats counter
                # deltas on the monitor's tick, and the straggler registry
                # self-prunes — a success pays only the sampling stride
                if h._dur_skip:
                    h._dur_skip -= 1
                else:
                    h.sample_turnaround(task, site, now)
            self._record(task, "ok")
            if self.restart_log is not None and task.durable:
                self.restart_log.append(task.key, value)
            if self.journal is not None:
                self.journal.task_done(task.key, value)
            tr = self.tracer
            if tr is not None:
                # inlined Tracer.task_done: stamp the output's critical-path
                # length before the set() fires downstream callbacks
                # (dependents read it in _ready)
                tr.tasks_done += 1
                path = task.path0 + now
                if path > tr.critical_path_s:
                    tr.critical_path_s = path
                task.output.path = path
                sp = task.span
                if sp is not None:
                    tr._close_span(sp, task, now, "ok")
            task.args = ()             # resolved chains must be GC-able: a
            task.fault_check = None    # retained record must not pin its
            task.output.set(value)     # upstream futures (DESIGN.md §9)
            return
        # failure path (§3.12)
        if getattr(err, "kind", None) == "revoked":
            # administrative drain revocation (DESIGN.md §13): a drained
            # service handed the still-queued task back — re-place it on
            # another site without charging a retry or denting the score
            self.tasks_revoked += 1
            if self.health is not None:
                self.health.task_revoked(task)
            if self.tracer is not None:
                self.tracer.event("revoked", now)
            if self.journal is not None and self.journal.full:
                self.journal.task_revoked(task.key)
            self._dispatch(task, exclude_site=site.name)
            return
        site.on_failure()
        # no monitor hook on failure: error windows come from Site.stats
        # counter deltas, and the straggler registry entry (if any) tracks
        # the live task across its retries (HealthMonitor.task_finished)
        failures = task.site_failures
        if failures is None:
            failures = task.site_failures = {}
        failures[site.name] = failures.get(site.name, 0) + 1
        self._record(task, "retried" if task.retries_left > 0 else "failed",
                     error=str(err))
        tr = self.tracer
        if tr is not None:
            status = "retried" if task.retries_left > 0 else "failed"
            path = tr.task_done(task, now, status)
            if status == "failed":
                task.output.path = path
        if task.retries_left <= 0:
            self.tasks_failed += 1
            if self.journal is not None:
                self.journal.task_failed(task.key, str(err))
            task.args = ()
            task.fault_check = None
            task.output.set_error(err or TaskFailure(f"{task.name} failed"))
            return
        task.retries_left -= 1
        task.attempt += 1
        exclude = None
        kind = getattr(err, "kind", "transient")
        if (kind == "site" or failures[site.name]
                >= self.retry_policy.site_fail_threshold):
            exclude = site.name  # reschedule at a different site
        self.clock.schedule(self.retry_policy.backoff,
                            lambda: self._dispatch(task, exclude_site=exclude))

    def _record(self, task: Task, status: str, error: str = ""):
        now = self.clock.now()
        if not self._prov_records:
            self.vdc.tally(status == "ok",
                           task.start_time - task.submit_time,
                           now - task.start_time)
            return
        sp = getattr(task, "span", None)
        self.vdc.record(InvocationRecord(
            task_id=str(task.id), name=task.name,
            site=task.site.name if task.site else "",
            host=task.host, submit_time=task.submit_time,
            start_time=task.start_time, end_time=now,
            exit_status=status, attempt=task.attempt,
            args_repr="", outputs=[task.output.name], error=error,
            span_id=sp.span_id if sp is not None else ""))

    def poke(self) -> None:
        """Schedule a pending-queue drain pass.  Completions trigger drains
        on their own; this exists for *external* capacity changes — the
        health monitor calls it when a site suspension lapses (the
        recovery probe), since with every site suspended no completion
        would ever arrive to unwedge the held backlog."""
        if self._pending and not self._drain_scheduled:
            self._drain_scheduled = True
            self.clock.schedule(0.0, self._drain_pending)

    # ------------------------------------------------------------------
    def run(self):
        self.clock.run()

    def stats(self) -> dict:
        return {
            "submitted": self.tasks_submitted,
            "completed": self.tasks_completed,
            "failed": self.tasks_failed,
            "restored_from_log": self.tasks_restored,
            "revoked": self.tasks_revoked,
            "makespan": self.clock.now(),
        }
