"""Unified task-lifecycle tracing, metrics registry, and run reports
(DESIGN.md §12).

Every figure in the paper — dispatch throughput (Fig 6), pipelining
(Fig 10), executor timelines (Fig 18) — is a view over per-task lifecycle
events, and the Kickstart/VDC provenance layer (§3.14) exists because
"reliable at scale" means knowing where each of a million tasks spent its
time.  This module is the one place that question is answered from:

  * `Tracer`          — bounded, deterministic per-task lifecycle spans
                        (submit -> ready -> queued -> staged -> running ->
                        done/failed/retried) plus component events (DRP
                        allocations, affinity redirects, mailbox flushes,
                        steals, bundle fusions).  Sampling keeps every k-th
                        task; the span store and every event log decimate
                        deterministically (drop every other entry, double
                        the stride — the `StreamStat` scheme, no RNG), so a
                        10^6-task run stays memory-bounded and two
                        `SimClock` runs of the same workflow produce
                        byte-identical span streams.
  * `MetricsRegistry` — aggregates every component's named metrics
                        (`FalkonService.metrics`, `DataLayer.metrics`,
                        pool/federation snapshots, bare `StreamStat`s)
                        into one JSON-able `snapshot()`.
  * `Tracer.export_chrome_trace` — Chrome trace-event / Perfetto JSON:
                        one process per site/shard, one thread track per
                        worker host, counter tracks for named logs
                        (queue length), instant events for component
                        events.
  * `RunReport`       — post-run analysis: critical-path length,
                        per-stage time breakdown, queue-wait / stage-wait
                        / run-time percentiles, per-site utilization
                        timeline.  `benchmarks/common.py` emits it as the
                        standard report schema; `tools/trace_view.py`
                        renders it (and validates chrome traces) from the
                        command line.

Hot-path contract: with no tracer attached every hook is a single
`is not None` test.  With a tracer attached, a *non-sampled* task costs
one counter increment plus the O(1) critical-path update at completion;
only every k-th task materializes a `Span` and touches the reservoirs.
All timestamps are passed in from the caller's clock — the tracer never
reads the wall clock and uses no RNG, so traces replay exactly under
`SimClock`.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional

from repro_torch.core.health import RollingStat
from repro_torch.core.metrics import StreamStat, percentile_of

__all__ = [
    "BoundedLog", "Span", "Tracer", "MetricsRegistry", "RunReport",
    "build_report",
]


class BoundedLog:
    """Append-only event log with bounded, deterministic decimation.

    The raw-trace analog of `StreamStat`'s reservoir: entries are kept
    every `stride`-th append, and when the kept list reaches `cap` every
    other entry is dropped (the first stays anchored) and the stride
    doubles — memory is bounded by `cap` for any run length, decimation is
    reproducible (no RNG), and `count` stays exact.  Used for the Falkon
    trace logs (`queue_len_log`, `alloc_log`, per-executor `task_log`),
    component event streams, and executor span tracks.
    """

    __slots__ = ("cap", "count", "entries", "_stride", "_skip")

    def __init__(self, cap: int = 1024):
        if cap < 2:
            raise ValueError("cap must be >= 2")
        self.cap = cap
        self.count = 0              # total appended (exact)
        self.entries: list = []     # kept subset, append order
        self._stride = 1
        self._skip = 0

    def append(self, entry) -> None:
        self.count += 1
        if self._skip:
            self._skip -= 1
            return
        self.entries.append(entry)
        if len(self.entries) >= self.cap:
            del self.entries[1::2]
            self._stride *= 2
        self._skip = self._stride - 1

    @property
    def stride(self) -> int:
        return self._stride

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, BoundedLog):
            return self.entries == other.entries
        return self.entries == other

    def __repr__(self):
        return (f"<BoundedLog n={self.count} kept={len(self.entries)} "
                f"stride={self._stride}>")


class Span:
    """One sampled task's lifecycle record.

    Timestamps are clock seconds (virtual under `SimClock`, wall under
    `RealClock`): `created` (submitted to the engine), `ready` (argument
    futures resolved; equals `created` for dependency-free tasks),
    `submitted` (handed to a site provider), `started` (body begins,
    after dispatch overhead + staging), `ended` (completion observed).
    `io_s` is the staging (stage-wait) time, `weight` the number of tasks
    this sampled span statistically represents (the sampling stride at
    creation), `shard` the federation shard (None outside a federation).
    """

    __slots__ = ("span_id", "name", "app", "shard", "site", "host",
                 "status", "attempt", "weight", "created", "ready",
                 "submitted", "started", "ended", "io_s")

    def __init__(self, span_id: str, name: str, app: str | None,
                 shard: int | None, created: float, weight: int):
        self.span_id = span_id
        self.name = name
        self.app = app
        self.shard = shard
        self.site = ""
        self.host = ""
        self.status = ""
        self.attempt = 0
        self.weight = weight
        self.created = created
        self.ready = created
        self.submitted = 0.0
        self.started = 0.0
        self.ended = 0.0
        self.io_s = 0.0

    def queue_wait(self) -> float:
        """Seconds between provider hand-off and body start (dispatch
        overhead + executor queueing + staging)."""
        return max(0.0, self.started - self.submitted)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id, "name": self.name, "app": self.app,
            "shard": self.shard, "site": self.site, "host": self.host,
            "status": self.status, "attempt": self.attempt,
            "weight": self.weight, "created": self.created,
            "ready": self.ready, "submitted": self.submitted,
            "started": self.started, "ended": self.ended,
            "io_s": self.io_s,
        }

    def __repr__(self):
        return (f"<Span {self.span_id} {self.name} {self.status} "
                f"[{self.started:.3f},{self.ended:.3f}]>")


class Tracer:
    """Bounded, deterministic recorder of task spans and component events.

    Construct once per run and hand the same instance to every component
    (`Engine(tracer=...)`, `FalkonService(tracer=...)`,
    `FederatedEngine(tracer=...)`, pools, data layers) — all components
    share one clock thread, so no locking is needed and event order is the
    clock's deterministic event order.

    Sampling: every `sample_every`-th submitted task gets a `Span`
    (`sample_every=1` records all).  When the closed-span store reaches
    `max_spans` it decimates — drop every other span, double the effective
    stride — so memory is bounded for any task count while early and late
    tasks both stay represented.  Exact (never sampled): task outcome
    counters, the critical-path length, and each component's own
    `StreamStat` aggregates (read via `MetricsRegistry`).

    Example::

        tracer = Tracer(sample_every=16)
        eng = Engine(clock, tracer=tracer)
        svc = FalkonService(clock, cfg, tracer=tracer)
        ... run ...
        tracer.export_chrome_trace("trace.json")     # chrome://tracing
        report = build_report(tracer, makespan=eng.clock.now())
    """

    def __init__(self, sample_every: int = 1, max_spans: int = 4096,
                 event_cap: int = 1024, log_cap: int = 2048,
                 rate_window: float = 60.0, rate_buckets: int = 12):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if max_spans < 2:
            raise ValueError("max_spans must be >= 2")
        self.sample_every = sample_every
        self.max_spans = max_spans
        self.event_cap = event_cap
        self.log_cap = log_cap
        # windowed per-kind event rates (DESIGN.md §13): `event_counts`
        # only gives cumulative totals, so two snapshots had to be diffed
        # by hand to see a rate; each kind also feeds a `RollingStat`
        self.rate_window = rate_window
        self.rate_buckets = rate_buckets
        self._event_rates: dict[str, RollingStat] = {}
        self._last_event_t = 0.0
        # event-stream subscribers (`subscribe`): called per event as
        # fn(kind, t, value).  Tuple, not list — the hot path iterates it
        # and the empty-tuple check is one truthiness test.
        self._subs: tuple = ()
        # exact counters (every task, sampled or not)
        self.tasks_seen = 0
        self.tasks_done = 0
        self.tasks_failed = 0
        self.tasks_retried = 0
        self.critical_path_s = 0.0
        # sampled state
        self._stride = 1             # doubles when the span store decimates
        self._k = sample_every       # sample_every * _stride, kept in sync
        self.spans: list[Span] = []  # closed sampled spans
        self._open_spans = 0
        # exact sum of closed-span weights (~= tasks the sampled spans
        # stand for).  Store decimation drops spans but not this counter,
        # so readers rescale kept-set estimates by
        # span_weight_total / sum(kept weights) — survivor weights are NOT
        # doubled on decimation (under mixed strides that compounds on the
        # always-kept head and explodes the estimate)
        self.span_weight_total = 0.0
        # per-stage aggregates, accumulated from sampled spans with their
        # weights: name -> [weighted count, run_s, queue_s, io_s]
        self.stage_cap = 512
        self._stages: dict[str, list] = {}
        # component events: kind -> exact [count, value_total] + bounded log
        self._event_agg: dict[str, list] = {}
        self.events: dict[str, BoundedLog] = {}
        # named gauges: last-value-wins scalars for state that is a level,
        # not a stream — recovery counters (``tasks_restored``,
        # ``recovery_wall_s``), journal depth, etc. (DESIGN.md §15)
        self.gauges: dict[str, float] = {}
        # executor occupancy track: (site, host, start, end, name)
        self.exec_spans = BoundedLog(cap=max(log_cap, 2))
        # named raw-series logs (Falkon queue length / allocations live
        # here when the service runs with trace=True)
        self.logs: dict[str, BoundedLog] = {}

    # -- named logs -----------------------------------------------------
    def log(self, name: str, cap: int | None = None) -> BoundedLog:
        """Get-or-create the named bounded log (e.g. ``falkon.queue_len``)."""
        lg = self.logs.get(name)
        if lg is None:
            self.logs[name] = lg = BoundedLog(cap or self.log_cap)
        return lg

    # -- task lifecycle (hot path) --------------------------------------
    def task_created(self, task, now: float,
                     shard: int | None = None) -> Optional[Span]:
        """Admit one submitted task; returns its `Span` if sampled (the
        caller stores it on ``task.span``), else None.  Deterministic:
        the decision is a counter modulus, never a coin flip."""
        self.tasks_seen += 1
        if (self.tasks_seen - 1) % self._k:
            return None
        return self._new_span(task, now, shard)

    def _new_span(self, task, now: float, shard: int | None) -> "Span":
        """Materialize the sampled-task span (the engine inlines the
        counter/modulus fast path and calls this only on a hit)."""
        span = Span(f"s{self.tasks_seen}", task.name, task.app, shard,
                    now, self._k)
        self._open_spans += 1
        return span

    def task_done(self, task, now: float, status: str = "ok") -> float:
        """Record a task outcome (engine completion path).  Updates exact
        counters and the critical path for *every* task; closes the span
        for sampled ones.  Returns the task's critical-path value (its
        dependency-chain latency), which the engine propagates onto the
        output future."""
        if status == "retried":
            self.tasks_retried += 1
            sp = getattr(task, "span", None)
            if sp is not None:
                sp.attempt = task.attempt + 1
            return 0.0
        if status == "ok":
            self.tasks_done += 1
        else:
            self.tasks_failed += 1
        # critical path: longest dependency chain of per-task latencies
        # (ready -> done); exact, O(1) per task (engine maintains
        # task.path0 = max over parent futures' path values)
        # the engine encodes (parent path - ready time) in path0; adding
        # `now` back yields the task's dependency-chain latency
        base = getattr(task, "path0", None)
        path = 0.0 if base is None else base + now
        if path > self.critical_path_s:
            self.critical_path_s = path
        sp = getattr(task, "span", None)
        if sp is not None:
            self._close_span(sp, task, now, status)
        return path

    def _close_span(self, sp: Span, task, now: float, status: str) -> None:
        sp.submitted = task.submit_time
        sp.started = task.start_time
        sp.ended = now
        sp.status = status
        sp.attempt = task.attempt
        site = task.site
        if site is not None:
            sp.site = site.name
        sp.host = task.host
        self._open_spans -= 1
        # weighted per-stage aggregate (estimates scale by span weight, so
        # they stay consistent across store decimations)
        st = self._stages.get(sp.name)
        if st is None:
            if len(self._stages) >= self.stage_cap:
                name = "<other>"
                st = self._stages.get(name)
                if st is None:
                    self._stages[name] = st = [0, 0.0, 0.0, 0.0]
            else:
                self._stages[sp.name] = st = [0, 0.0, 0.0, 0.0]
        w = sp.weight
        st[0] += w
        st[1] += w * (now - sp.started)
        st[2] += w * sp.queue_wait()
        st[3] += w * sp.io_s
        self.span_weight_total += w
        spans = self.spans
        spans.append(sp)
        if len(spans) >= self.max_spans:
            del spans[1::2]
            self._stride *= 2
            self._k = self.sample_every * self._stride

    # -- component events -----------------------------------------------
    def subscribe(self, fn: Callable[[str, float, float], None]) -> None:
        """Register an event-stream listener, called synchronously as
        ``fn(kind, t, value)`` for every `event` — the `HealthMonitor`
        subscribes here to fold component events into its windowed
        alerts.  Listeners must not block (they run on the clock thread)."""
        self._subs = self._subs + (fn,)

    def event(self, kind: str, t: float, value: float = 1.0) -> None:
        """Record one component event (``drp_alloc``, ``affinity_park``,
        ``mailbox_flush``, ``steal``, ``bundle_fused``, ``stage_bytes``,
        ...): exact count/total per kind, a bounded (t, value) log, and a
        rolling windowed rate (`event_rates`).  Subscribers see every
        event."""
        agg = self._event_agg.get(kind)
        if agg is None:
            self._event_agg[kind] = agg = [0, 0.0]
            self.events[kind] = BoundedLog(self.event_cap)
            self._event_rates[kind] = RollingStat(self.rate_window,
                                                  self.rate_buckets)
        agg[0] += 1
        agg[1] += value
        self.events[kind].append((t, value))
        self._event_rates[kind].observe(t, value)
        if t > self._last_event_t:
            self._last_event_t = t
        if self._subs:
            for fn in self._subs:
                fn(kind, t, value)

    def gauge(self, name: str, value: float) -> None:
        """Set a named gauge (last value wins).  Gauges appear in
        `snapshot()` and in the `RunReport` payload; on `merge_snapshot`
        they *sum* across processes (every current user is an additive
        count — restored tasks, journal rows)."""
        self.gauges[name] = float(value)

    def exec_span(self, site: str, host: str, start: float, end: float,
                  name: str = "") -> None:
        """Record one executor-occupancy interval (the Fig-18 / worker
        timeline data): bounded, one shared log across sites."""
        self.exec_spans.append((site, host, start, end, name))

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another process's `snapshot()` into this tracer
        (DESIGN.md §14): exact task counters add, the critical path takes
        the max, and per-kind event aggregates accumulate, so a
        `RunReport` built from the merged tracer covers the whole
        process-per-shard federation.  Sampled spans and bounded event
        logs are process-local and are *not* reconstructed — percentile
        and timeline views stay per-process (each shard can export its
        own trace); the merged report's counters and event totals are
        exact."""
        self.tasks_seen += snap["tasks_seen"]
        self.tasks_done += snap["tasks_done"]
        self.tasks_failed += snap["tasks_failed"]
        self.tasks_retried += snap["tasks_retried"]
        if snap["critical_path_s"] > self.critical_path_s:
            self.critical_path_s = snap["critical_path_s"]
        for kind, d in snap.get("events", {}).items():
            agg = self._event_agg.get(kind)
            if agg is None:
                self._event_agg[kind] = agg = [0, 0.0]
                self.events[kind] = BoundedLog(self.event_cap)
                self._event_rates[kind] = RollingStat(self.rate_window,
                                                      self.rate_buckets)
            agg[0] += d["count"]
            agg[1] += d["total"]
        for name, v in snap.get("gauges", {}).items():
            self.gauges[name] = self.gauges.get(name, 0.0) + v

    # -- snapshots ------------------------------------------------------
    def event_counts(self) -> dict:
        return {k: {"count": a[0], "total": a[1]}
                for k, a in sorted(self._event_agg.items())}

    def event_rates(self, now: float | None = None) -> dict:
        """Windowed per-kind event rates over the trailing `rate_window`
        seconds (the satellite to `event_counts`' cumulative totals).
        `now` defaults to the newest event timestamp seen — callers with a
        clock should pass its now() so stale kinds decay to zero."""
        if now is None:
            now = self._last_event_t
        w = self.rate_window
        out = {}
        for kind in sorted(self._event_rates):
            rs = self._event_rates[kind]
            c = rs.count(now)
            out[kind] = {"window_s": w, "count": c,
                         "rate_per_s": c / w,
                         "value_per_s": rs.total(now) / w}
        return out

    def stage_breakdown(self) -> dict:
        """Per-stage estimated totals: task count, run seconds, queue-wait
        seconds, stage-wait (staging I/O) seconds.  Estimates are
        weighted sampled sums — exact when ``sample_every == 1`` and the
        span store never decimated."""
        return {
            name: {
                "count_est": st[0],
                "run_s_est": st[1],
                "run_s_mean": st[1] / st[0] if st[0] else 0.0,
                "queue_s_est": st[2],
                "queue_s_mean": st[2] / st[0] if st[0] else 0.0,
                "io_s_est": st[3],
            }
            for name, st in sorted(self._stages.items())
        }

    def snapshot(self) -> dict:
        """Bounded self-description — safe at any task count."""
        return {
            "tasks_seen": self.tasks_seen,
            "tasks_done": self.tasks_done,
            "tasks_failed": self.tasks_failed,
            "tasks_retried": self.tasks_retried,
            "critical_path_s": self.critical_path_s,
            "sampled_spans": len(self.spans),
            "open_spans": self._open_spans,
            "sample_stride": self.sample_every * self._stride,
            "events": self.event_counts(),
            "event_rates": self.event_rates(),
            "gauges": dict(self.gauges),
        }

    # -- chrome trace export --------------------------------------------
    def export_chrome_trace(self, path: str | None = None) -> dict:
        """Serialize to Chrome trace-event JSON (the format
        chrome://tracing and Perfetto load): one *process* per site (or
        federation shard), one *thread* track per worker host, complete
        ("X") events for task spans and executor occupancy, counter ("C")
        tracks for named logs, instant ("i") events for component events.
        Returns the trace dict; writes it to `path` when given."""
        events: list[dict] = []
        pids: dict[str, int] = {}
        tids: dict[tuple, int] = {}

        def pid_of(proc: str) -> int:
            p = pids.get(proc)
            if p is None:
                pids[proc] = p = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": p, "tid": 0,
                               "args": {"name": proc}})
            return p

        def tid_of(p: int, thread: str) -> int:
            key = (p, thread)
            t = tids.get(key)
            if t is None:
                # per-process thread numbering, 1-based; 0 is the
                # process-level track for span/counter events with no host
                t = sum(1 for (pp, _) in tids if pp == p) + 1
                tids[key] = t
                events.append({"ph": "M", "name": "thread_name",
                               "pid": p, "tid": t,
                               "args": {"name": thread}})
            return t

        for sp in self.spans:
            proc = (f"shard{sp.shard}" if sp.shard is not None
                    else (sp.site or "engine"))
            p = pid_of(proc)
            t = tid_of(p, sp.host) if sp.host else 0
            events.append({
                "ph": "X", "cat": "task", "name": sp.name,
                "pid": p, "tid": t,
                "ts": sp.started * 1e6,
                "dur": max(0.0, sp.ended - sp.started) * 1e6,
                "args": {"span_id": sp.span_id, "status": sp.status,
                         "attempt": sp.attempt, "weight": sp.weight,
                         "queue_wait_s": sp.queue_wait(),
                         "io_s": sp.io_s, "site": sp.site},
            })
        for site, host, start, end, name in self.exec_spans:
            p = pid_of(site or "pool")
            t = tid_of(p, host) if host else 0
            events.append({
                "ph": "X", "cat": "executor", "name": name or "task",
                "pid": p, "tid": t,
                "ts": start * 1e6, "dur": max(0.0, end - start) * 1e6,
                "args": {},
            })
        for log_name, lg in sorted(self.logs.items()):
            p = pid_of("counters")
            for t_s, v in lg:
                events.append({
                    "ph": "C", "cat": "counter", "name": log_name,
                    "pid": p, "tid": 0, "ts": t_s * 1e6,
                    "args": {"value": v},
                })
        for kind in sorted(self.events):
            p = pid_of("events")
            t = tid_of(p, kind)
            for t_s, v in self.events[kind]:
                events.append({
                    "ph": "i", "cat": "component", "name": kind,
                    "pid": p, "tid": t, "ts": t_s * 1e6, "s": "t",
                    "args": {"value": v},
                })
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        trace = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"schema": "repro.chrome_trace/v1",
                          **{k: v for k, v in self.snapshot().items()
                             if k not in ("events", "event_rates")}},
        }
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(trace, f)
        return trace


class MetricsRegistry:
    """One snapshot over every component's named metrics.

    Components register under a name; `snapshot()` normalizes each source
    — an object exposing ``metrics()`` (Falkon service, data layer, pools,
    federation), ``summary()`` (a bare `StreamStat`), ``stats()`` (an
    engine), a zero-arg callable, or a plain dict — into one JSON-able
    mapping.  Registration is O(1); nothing is polled until `snapshot()`.

    Example::

        reg = MetricsRegistry()
        reg.register("falkon", svc)
        reg.register("queue_wait", some_streamstat)
        json.dumps(reg.snapshot())
    """

    def __init__(self):
        self._sources: dict[str, Any] = {}

    def register(self, name: str, source: Any) -> Any:
        if name in self._sources:
            raise ValueError(f"metrics source {name!r} already registered")
        self._sources[name] = source
        return source

    def names(self) -> list[str]:
        return list(self._sources)

    @staticmethod
    def _snap(source: Any) -> Any:
        for attr in ("metrics", "summary", "snapshot", "stats"):
            fn = getattr(source, attr, None)
            if callable(fn):
                return fn()
        if callable(source):
            return source()
        return source

    def snapshot(self) -> dict:
        """Collect every registered source into one JSON-able dict."""
        return {name: self._snap(src)
                for name, src in self._sources.items()}

    def to_json(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=2, default=str)
        return snap


REPORT_SCHEMA = "repro.run_report/v1"


class RunReport:
    """Post-run analysis over a `Tracer` (and optionally a
    `MetricsRegistry`): the standard report every benchmark emits.

    Fields: exact task counters; critical-path length and its ratio to the
    makespan (1.0 = the run was dependency-bound, ≪1 = resource-bound);
    per-stage time breakdown (the Fig-10 view); queue-wait / stage-wait /
    run-time percentiles from the sampled spans; a per-site utilization
    timeline (estimated busy executors per time bin, scaled by span
    weights); and the registry's component snapshot.  Build with
    `build_report`; render with `format()` or `tools/trace_view.py`.
    """

    def __init__(self, payload: dict):
        self.payload = payload

    def __getitem__(self, key):
        return self.payload[key]

    def get(self, key, default=None):
        return self.payload.get(key, default)

    def to_dict(self) -> dict:
        return self.payload

    def to_json(self, path: str) -> dict:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.payload, f, indent=2, default=str)
        return self.payload

    def format(self) -> str:
        """Human-readable multi-line rendering of the report."""
        p = self.payload
        lines = [
            f"run report (schema {p['schema']})",
            f"  makespan           {p['makespan_s']:.3f} s",
            f"  tasks              done={p['tasks']['done']} "
            f"failed={p['tasks']['failed']} "
            f"retried={p['tasks']['retried']} "
            f"(sampled {p['tasks']['sampled_spans']}, "
            f"stride {p['tasks']['sample_stride']})",
            f"  critical path      {p['critical_path_s']:.3f} s "
            f"(ratio {p['critical_path_ratio']:.2f})",
        ]
        pct = p["percentiles"]
        for key in ("queue_wait_s", "stage_wait_s", "run_s"):
            d = pct[key]
            lines.append(
                f"  {key:<18} p50={d['p50']:.4f} p95={d['p95']:.4f} "
                f"p99={d['p99']:.4f} max={d['max']:.4f}")
        lines.append("  stages:")
        for name, st in p["stages"].items():
            lines.append(
                f"    {name:<24} n~{st['count_est']:<8} "
                f"run={st['run_s_est']:.1f}s "
                f"queue={st['queue_s_est']:.1f}s "
                f"io={st['io_s_est']:.1f}s")
        util = p["utilization"]
        for site, series in util["sites"].items():
            peak = max(series) if series else 0.0
            lines.append(f"  site {site}: peak ~{peak:.1f} busy "
                         f"({util['bins']} bins of {util['bin_s']:.3f}s)")
        if p.get("events"):
            lines.append("  events: " + ", ".join(
                f"{k}={v['count']}" for k, v in p["events"].items()))
        return "\n".join(lines)


def _pct_block(values: list) -> dict:
    vals = sorted(values)
    n = len(vals)
    return {
        "count": n,
        "mean": sum(vals) / n if n else 0.0,
        "p50": percentile_of(vals, 0.50),
        "p95": percentile_of(vals, 0.95),
        "p99": percentile_of(vals, 0.99),
        "max": vals[-1] if n else 0.0,
        "min": vals[0] if n else 0.0,
    }


def build_report(tracer: Tracer, registry: MetricsRegistry | None = None,
                 makespan: float | None = None,
                 utilization_bins: int = 32) -> RunReport:
    """Assemble the standard `RunReport` from a tracer (and optionally a
    registry) after the run drains.  `makespan` defaults to the latest
    span end observed — pass the workload's real completion time when the
    run had trailing events (samplers, shrink sweeps)."""
    spans = tracer.spans
    if makespan is None:
        makespan = max((sp.ended for sp in spans), default=0.0)
    queue_waits = [sp.queue_wait() for sp in spans]
    stage_waits = [sp.io_s for sp in spans]
    run_times = [max(0.0, sp.ended - sp.started) for sp in spans]
    # per-site utilization timeline: each sampled span contributes its
    # overlap with every bin, scaled by its weight -> estimated busy
    # executors per bin per site
    bins = max(1, utilization_bins)
    width = makespan / bins if makespan > 0 else 1.0
    # decimation keeps a uniform-in-time 1-in-2^d subsample of the closed
    # spans without touching their weights; one global factor rescales the
    # kept set back to the full closed population
    kept_w = sum(sp.weight for sp in spans)
    scale = tracer.span_weight_total / kept_w if kept_w else 1.0
    sites: dict[str, list] = {}
    for sp in spans:
        site = sp.site or "engine"
        series = sites.get(site)
        if series is None:
            sites[site] = series = [0.0] * bins
        lo, hi = sp.started, min(sp.ended, makespan)
        if hi <= lo:
            continue
        b0 = min(bins - 1, int(lo / width))
        b1 = min(bins - 1, int(hi / width))
        for b in range(b0, b1 + 1):
            bin_lo, bin_hi = b * width, (b + 1) * width
            overlap = min(hi, bin_hi) - max(lo, bin_lo)
            if overlap > 0:
                series[b] += scale * sp.weight * overlap / width
    payload = {
        "schema": REPORT_SCHEMA,
        "makespan_s": makespan,
        "tasks": {
            "seen": tracer.tasks_seen,
            "done": tracer.tasks_done,
            "failed": tracer.tasks_failed,
            "retried": tracer.tasks_retried,
            "sampled_spans": len(spans),
            "sample_stride": tracer.sample_every * tracer._stride,
        },
        "critical_path_s": tracer.critical_path_s,
        "critical_path_ratio": (tracer.critical_path_s / makespan
                                if makespan > 0 else 0.0),
        "stages": tracer.stage_breakdown(),
        "percentiles": {
            "queue_wait_s": _pct_block(queue_waits),
            "stage_wait_s": _pct_block(stage_waits),
            "run_s": _pct_block(run_times),
        },
        "utilization": {"bins": bins, "bin_s": width,
                        "sites": {k: sites[k] for k in sorted(sites)}},
        "events": tracer.event_counts(),
        "gauges": dict(tracer.gauges),
        "components": registry.snapshot() if registry is not None else {},
    }
    return RunReport(payload)
