"""Online health observability: rolling windows, straggler detection, and
error-rate-driven site drain (DESIGN.md §13).

The `Tracer`/`RunReport` of `observability` explain a run *after* it ends; this module
watches it *while* it executes and feeds what it sees back into placement —
the closed loop behind the paper's "reliable" claim (§3.12: route around
bad resources while 10^5-10^6 tasks are in flight).  Three pieces:

  * `RollingStat`    — a time-windowed ring of buckets over the `Clock`.
                       Windowing is pure epoch arithmetic on caller-passed
                       timestamps (``epoch = int(t / bucket_s)``) — no wall
                       reads, no RNG — so the same workflow under `SimClock`
                       produces byte-identical windowed rates on every
                       replay, and the identical code runs under `RealClock`.
  * `HealthMonitor`  — subscribes to engine task completions (dispatch /
                       finish hooks), Falkon executor completions, and the
                       `Tracer.event()` stream, and derives per-site health
                       states (``healthy -> degraded -> drained ->
                       blacklisted``, probe-based recovery), straggler
                       flags (running > k x rolling-p95 for the task's
                       vmap signature/app), and backpressure watermarks.
  * feedback         — state changes actuate through existing seams:
                       `Site.suspended_until` (drain/blacklist; the
                       balancer and the federation stealer already skip
                       suspended sites), `Site.derate` (degraded sites
                       keep serving but at reduced weight), and
                       `FalkonService.drain_queued` (revoke queued tasks
                       from a drained service so the engine re-places them
                       on healthy sites without charging retries).

The monitor also emits a periodic JSONL metrics stream (schema
``repro.metrics_stream/v1``): one line per cadence with per-site health,
windowed rates, queue depths, and — when a `MetricsRegistry` is attached —
the full component snapshot.  `tools/live_monitor.py` tails it;
`tools/trace_view.py validate` checks it.

Hot-path contract (same as the tracer's): with no monitor attached every
engine/service hook is a single ``is not None`` test.  With one attached, a
successful completion costs one counter decrement plus, for one in
`duration_stride` completions, a sampled turnaround update — it never
touches the straggler registry (resolved entries are pruned lazily), and
the windowed error accounting itself runs *off* the completion path, on a
bucket-cadence tick that folds `Site.stats` counter deltas (already
maintained by the engine) into the rolling windows and runs the state
machine.  The tick is self-disarming: it arms on dispatch activity and
stops when the watched engines go idle, so a `SimClock.run()` still
terminates.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Callable, Optional

from repro_torch.core.metrics import percentile_of

__all__ = ["RollingStat", "HealthConfig", "HealthMonitor",
           "METRICS_STREAM_SCHEMA"]

# JSONL metrics-stream schema tag; every emitted line carries it and
# `tools/trace_view.py validate` rejects lines without it.
METRICS_STREAM_SCHEMA = "repro.metrics_stream/v1"


class RollingStat:
    """Time-windowed (count, total, samples) over a ring of buckets.

    Observations land in the bucket ``int(t / bucket_s)``; a query at time
    `now` first expires every bucket older than the window, then reduces
    over the survivors — O(buckets) per query, O(1) amortized per observe.
    Timestamps come from the caller's clock (virtual under `SimClock`, wall
    under `RealClock`); the structure itself never reads a clock and uses
    no RNG, so replays are exact.

    With ``keep_samples > 0`` each bucket additionally keeps its first k
    observed values, enabling windowed percentiles (`percentile`) — the
    straggler detector's rolling p95 lives on this.

    Example::

        rs = RollingStat(window=30.0, buckets=10)
        rs.observe(t, 1.0 if failed else 0.0)     # per completion
        err = rs.mean(now)                        # windowed error rate
        thr = rs.rate(now)                        # events per second
    """

    __slots__ = ("window", "buckets", "bucket_s", "keep_samples",
                 "_ring", "_head")

    def __init__(self, window: float = 30.0, buckets: int = 10,
                 keep_samples: int = 0):
        if window <= 0.0:
            raise ValueError("window must be > 0")
        if buckets < 1:
            raise ValueError("buckets must be >= 1")
        self.window = float(window)
        self.buckets = buckets
        self.bucket_s = self.window / buckets
        self.keep_samples = keep_samples
        # ring entry: [count, total, samples-or-None], indexed epoch % n
        self._ring = [[0, 0.0, None] for _ in range(buckets)]
        self._head: Optional[int] = None    # newest epoch seen

    def _advance(self, t: float) -> None:
        """Expire buckets between the last-seen epoch and `t`'s epoch."""
        e = int(t / self.bucket_s)
        head = self._head
        if head is None:
            self._head = e
            return
        if e <= head:
            return
        n = self.buckets
        if e - head >= n:
            for b in self._ring:
                b[0] = 0
                b[1] = 0.0
                b[2] = None
        else:
            ring = self._ring
            for k in range(head + 1, e + 1):
                b = ring[k % n]
                b[0] = 0
                b[1] = 0.0
                b[2] = None
        self._head = e

    def observe(self, t: float, v: float = 1.0) -> None:
        """Record one observation at clock time `t` with value `v`."""
        self._advance(t)
        e = int(t / self.bucket_s)
        if self._head - e >= self.buckets:
            return                      # older than the whole window
        b = self._ring[e % self.buckets]
        b[0] += 1
        b[1] += v
        if self.keep_samples:
            s = b[2]
            if s is None:
                b[2] = s = []
            if len(s) < self.keep_samples:
                s.append(v)

    # -- windowed queries (all expire stale buckets first) --------------
    def count(self, now: float) -> int:
        """Observations inside the window ending at `now`."""
        self._advance(now)
        return sum(b[0] for b in self._ring)

    def total(self, now: float) -> float:
        """Sum of observed values inside the window."""
        self._advance(now)
        return sum(b[1] for b in self._ring)

    def mean(self, now: float) -> float:
        """Windowed mean value — the windowed *rate* for 0/1 indicators
        (e.g. error fraction when observing 1.0 per failure)."""
        self._advance(now)
        c = t = 0.0
        for b in self._ring:
            c += b[0]
            t += b[1]
        return t / c if c else 0.0

    def rate(self, now: float) -> float:
        """Observations per second over the window."""
        return self.count(now) / self.window

    def value_rate(self, now: float) -> float:
        """Value sum per second over the window (e.g. bytes/s)."""
        return self.total(now) / self.window

    def percentile(self, q: float, now: float) -> float:
        """Windowed q-quantile of kept samples (0.0 when none kept;
        requires ``keep_samples > 0`` to be meaningful)."""
        self._advance(now)
        vals: list = []
        for b in self._ring:
            s = b[2]
            if s:
                vals.extend(s)
        vals.sort()
        return percentile_of(vals, q)

    def observe_bulk(self, t: float, count: int, total: float) -> None:
        """Fold `count` observations summing to `total` into the bucket at
        time `t` in one call — the counter-delta path (the `HealthMonitor`
        tick aggregates a whole bucket's completions at once instead of
        paying one `observe` per task).  Kept samples are not updated."""
        if count <= 0:
            return
        self._advance(t)
        e = int(t / self.bucket_s)
        if self._head - e >= self.buckets:
            return
        b = self._ring[e % self.buckets]
        b[0] += count
        b[1] += total

    def snapshot(self, now: float) -> dict:
        """JSON-able windowed summary."""
        self._advance(now)
        c = sum(b[0] for b in self._ring)
        t = sum(b[1] for b in self._ring)
        return {"window_s": self.window, "count": c, "total": t,
                "mean": t / c if c else 0.0,
                "rate_per_s": c / self.window}

    def __repr__(self):
        return (f"<RollingStat window={self.window}s "
                f"buckets={self.buckets}>")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds and cadences for the `HealthMonitor` state machine.

    Error-rate thresholds are windowed per-attempt failure fractions over
    `window` seconds (clock time), evaluated only once `min_samples`
    completions are in the window.  `degrade_*` softens a site's balancer
    weight; `drain_*`/`blacklist_*` suspend it outright via the
    `Site.suspended_until` seam (backoffs escalate by `backoff_factor` per
    consecutive failed probe).  Recovery is probe-based: when a suspension
    lapses, traffic flows again and the next window of fresh samples either
    recovers the site (error <= `recover_error_rate`) or re-drains it.
    """

    window: float = 30.0            # rolling window (clock seconds)
    buckets: int = 10               # ring granularity
    min_samples: int = 8            # completions before thresholds engage
    degrade_error_rate: float = 0.10
    drain_error_rate: float = 0.25
    blacklist_error_rate: float = 0.45
    recover_error_rate: float = 0.10
    degrade_derate: float = 0.5     # balancer weight multiplier when degraded
    drain_backoff: float = 60.0     # first drain suspension (probe delay)
    backoff_factor: float = 2.0     # escalation per consecutive re-drain
    blacklist_backoff: float = 600.0
    blacklist_after_drains: int = 3  # failed probes before blacklisting
    revoke_on_drain: bool = True    # hand queued tasks back on drain
    # straggler detection: a task in flight longer than
    # max(straggler_min_s, straggler_factor x rolling p95 turnaround for
    # its vmap signature / (app, name)) is flagged once
    straggler_factor: float = 3.0
    straggler_min_s: float = 1.0
    straggler_interval: float = 5.0     # scan cadence; <= 0 disables
    # in-flight tracking bound: dispatches past this many tracked tasks
    # are not registered for straggler detection until the registry
    # drains.  Providers accept work far beyond executor capacity
    # (queued internally), so an unbounded registry would mirror the
    # whole backlog — megabytes of cache-hostile state on a saturated
    # run — to watch tasks that are mostly queue-waiting anyway.  The
    # registry is a dispatch-ordered deque that completions never touch
    # (the §13 hot-path contract): resolved entries drain from its head
    # during scans, O(1) amortized per admitted task.  Small runs
    # (tests, the recovery benchmark) sit far below the cap and are
    # tracked exhaustively; error windows are exact regardless.
    straggler_track_cap: int = 8192
    duration_window: float = 120.0      # turnaround stats window
    duration_samples: int = 32          # kept samples per bucket
    # turnaround sampling stride: only every k-th successful completion
    # pays for percentile-reservoir updates (the tracer's span-sampling
    # idea, strided wider because reservoirs need less data than spans);
    # error windows are exact regardless — they come from Site.stats
    # counter deltas, not from sampling
    duration_stride: int = 32
    # per-executor drain (Falkon hosts): None disables
    executor_drain_error_rate: Optional[float] = None
    executor_min_samples: int = 6
    executor_backoff: float = 120.0
    # backpressure watermarks: ready backlog vs pool capacity
    queue_high_watermark: float = 2.0
    queue_low_watermark: float = 0.5
    emit_interval: float = 5.0          # JSONL cadence when a sink attached


class _SiteHealth:
    """Per-site monitor state (internal)."""

    __slots__ = ("site", "state", "outcomes", "latency", "lat_ewma",
                 "consecutive_drains", "stragglers", "revoked",
                 "seen_completed", "seen_failed", "last_fail_t")

    def __init__(self, site, cfg: HealthConfig):
        self.site = site
        self.state = "healthy"
        # fed by counter deltas each tick: count = windowed attempts,
        # total = windowed failed attempts
        self.outcomes = RollingStat(cfg.window, cfg.buckets)
        self.latency = RollingStat(cfg.duration_window, cfg.buckets,
                                   keep_samples=cfg.duration_samples)
        self.lat_ewma = 0.0
        self.consecutive_drains = 0
        self.stragglers = 0
        self.revoked = 0
        # high-water marks of Site.stats at the last tick (delta base)
        self.seen_completed = site.stats.completed
        self.seen_failed = site.stats.failed
        # last tick that folded a failure — lets the tick skip the state
        # machine exactly (windowed err is 0) on healthy, failure-free
        # sites
        self.last_fail_t = float("-inf")


class HealthMonitor:
    """Closed-loop run health: rolling per-site signals -> placement.

    Wire-up (the engine/service hooks stay single-``is not None``-test
    cheap when no monitor is attached)::

        hm = HealthMonitor(clock, tracer=tracer, registry=registry)
        hm.watch(engine)            # or a FederatedEngine
        hm.watch_service(svc)       # per-executor signals + drain_queued
        hm.attach_sink("run.jsonl") # periodic metrics-stream emission
        ... run ...
        hm.states()                 # {"site0": "healthy", ...}
        hm.transitions              # state-change log (deterministic
                                    # under SimClock)

    State machine per site: ``healthy -> degraded`` (windowed error rate
    over `degrade_error_rate`: the site keeps serving at `degrade_derate`
    balancer weight), ``-> drained`` (over `drain_error_rate`: suspended
    for `drain_backoff`, queued tasks optionally revoked back to the
    engine), ``-> blacklisted`` (over `blacklist_error_rate`, or repeated
    failed probes: long suspension).  Recovery is probe-based — a lapsed
    suspension lets traffic flow; a clean fresh window transitions back to
    healthy, a dirty one re-drains with escalated backoff.
    """

    def __init__(self, clock, config: HealthConfig | None = None,
                 tracer=None, registry=None,
                 on_straggler: Callable | None = None):
        self.clock = clock
        self.cfg = config or HealthConfig()
        self.tracer = tracer
        self.registry = registry
        # re-dispatch hint: called as on_straggler(task, in_flight_s,
        # threshold_s) when a straggler is flagged
        self.on_straggler = on_straggler
        self._sites: dict[str, _SiteHealth] = {}
        self._engines: list = []
        self._services: list = []
        # straggler registry: tasks in dispatch order, appended at
        # `_place` while under `straggler_track_cap`, never touched by
        # completions — resolved entries drain from the head during
        # scans (§13 hot-path contract)
        self._running: deque = deque()
        self._flagged: set[int] = set()        # straggler-flagged task ids
        # turnaround stats per vmap signature / (app, name), shared across
        # sites; bounded key cardinality (workflow-level)
        self._durations: dict = {}
        self._dur_skip = 0
        self._exec_stats: dict = {}            # (svc, eid) -> RollingStat
        self.transitions: list[dict] = []      # exact state-change log
        self.straggler_log: deque = deque(maxlen=256)
        self.stragglers_flagged = 0
        self.tasks_revoked = 0
        self.executors_drained = 0
        self.lines_emitted = 0
        # single cadence driver: one clock event per bucket interval runs
        # counter-delta accounting + the state machine, and on their own
        # due-times the straggler scan / stream emission.  The interval
        # adapts: while every site is healthy and completions are sparse
        # the tick stretches (doubling, capped at one window) so its
        # cost stays a bounded fraction of completion volume; any failure
        # delta or non-healthy site snaps it back to bucket resolution.
        # Worst-case detection latency for the *first* failure burst is
        # one stretched interval (<= window) — busy or failing runs
        # always tick at full resolution.
        self._tick_s = self.cfg.window / self.cfg.buckets
        self._tick_cur = self._tick_s
        self._tick_max = max(self._tick_s, self.cfg.window)
        self._stretch_min = 32      # completions/tick below which to stretch
        self._next_scan = 0.0
        self._next_emit = 0.0
        self._emit_interval = self.cfg.emit_interval
        # straggler-scan threshold cache: per-key flag thresholds and
        # their minimum (the floor), recomputed at most once per duration
        # bucket — the percentile sorts run at bucket cadence, not scan
        # cadence.  The O(1) head-age-vs-floor pre-check skips the whole
        # scan when nothing can possibly be flagged.
        self._thresholds: dict = {}
        self._thr_floor = 0.0
        self._thr_at = float("-inf")
        self._thr_refresh = self.cfg.duration_window / self.cfg.buckets
        self._armed = False
        self._stride = max(1, self.cfg.duration_stride)
        self._track_cap = max(0, self.cfg.straggler_track_cap)
        self._bp_high = False
        self._sink = None
        self._own_sink = False
        if tracer is not None and hasattr(tracer, "subscribe"):
            # component-event stream (satellite of the same loop): fold
            # alert-worthy kinds into windowed rates for the snapshots
            tracer.subscribe(self._on_event)
        self._alerts: dict[str, RollingStat] = {}

    # -- wiring ---------------------------------------------------------
    def watch(self, target):
        """Attach to an `Engine` or `FederatedEngine` (all shards).
        Returns the target for chaining."""
        shards = getattr(target, "shards", None)
        if shards is not None and hasattr(target, "mailboxes"):
            target.health = self
            for eng in shards:
                self.watch(eng)
            return target
        target.health = self
        self._engines.append(target)
        return target

    def watch_service(self, svc):
        """Attach to a `FalkonService`: enables queue-depth readings for
        its site and — when `executor_drain_error_rate` is configured —
        per-executor windowed error tracking.  The service-side completion
        hook is only installed when executor tracking is on, so the common
        site-level-only configuration adds zero service hot-path cost."""
        if self.cfg.executor_drain_error_rate is not None:
            svc.health = self
        self._services.append(svc)
        return svc

    def attach_sink(self, sink, interval: float | None = None) -> None:
        """Emit the JSONL metrics stream (``repro.metrics_stream/v1``) to
        `sink` — a path or a file-like object — every `emit_interval`
        clock seconds while the watched engines have work in flight."""
        if isinstance(sink, str):
            sink = open(sink, "w", encoding="utf-8")
            self._own_sink = True
        self._sink = sink
        if interval is not None:
            self._emit_interval = float(interval)
        self._next_emit = 0.0

    def close(self) -> None:
        """Flush and close an owned sink (no-op for caller-owned files)."""
        if self._sink is not None and self._own_sink:
            self._sink.close()
            self._sink = None

    # -- hooks (engine / service hot path) ------------------------------
    # The engine inlines the bodies of `task_dispatched` / `task_finished`
    # directly in `_place` / `_done` (same idiom as its inlined
    # Tracer.task_done) — a bound-method call per task would alone eat
    # half the 5% overhead budget.  These methods are the reference
    # implementation and the path for other drivers.

    def arm(self) -> None:
        """Start the tick cadence (idempotent; called on the first
        dispatch after an idle period)."""
        if not self._armed:
            self._armed = True
            self._tick_cur = self._tick_s
            self.clock.schedule(self._tick_s, self._tick)

    def task_dispatched(self, task, now: float) -> None:
        """Engine `_place` hook: the task was handed to a site.  Hot-path
        cost: arming the tick cadence when idle, plus one deque append
        while the registry is under `straggler_track_cap`."""
        if not self._armed:
            self.arm()
        r = self._running
        if len(r) < self._track_cap:
            r.append(task)

    def task_finished(self, task, site, ok: bool, now: float) -> None:
        """Engine `_done` hook: one attempt finished (success or failure,
        but not drain revocation — see `task_revoked`).  Neither outcome
        touches the straggler registry: a resolved entry drains from the
        deque head during scans, and a retried task's entry tracks the
        live object (its `submit_time` is re-stamped on re-placement).
        A success pays the sampling stride counter; every
        `duration_stride`-th success samples its turnaround into the
        percentile reservoirs (`sample_turnaround`).  Error windows are
        NOT updated here — the tick derives them exactly from
        `Site.stats` counter deltas."""
        if ok:
            if self._dur_skip:
                self._dur_skip -= 1
            else:
                self.sample_turnaround(task, site, now)

    def sample_turnaround(self, task, site, now: float) -> None:
        """The 1-in-`duration_stride` sampled completion: feed the site
        EWMA / windowed latency percentiles and the per-signature
        turnaround reservoirs behind straggler thresholds."""
        self._dur_skip = self._stride - 1
        turnaround = now - task.submit_time
        sh = self._sites.get(site.name)
        if sh is None:
            sh = self._site_state(site)
        # EWMA over the *sampled* turnarounds — the cheap latency
        # signal next to the windowed percentiles
        sh.lat_ewma = (turnaround if sh.lat_ewma == 0.0
                       else 0.8 * sh.lat_ewma + 0.2 * turnaround)
        sh.latency.observe(now, turnaround)
        key = task.vmap_key
        if key is None:
            key = (task.app, task.name)
        rs = self._durations.get(key)
        if rs is None and len(self._durations) < 512:
            # bounded key cardinality: past the cap, per-key
            # duration stats stop growing (site stats still update)
            self._durations[key] = rs = RollingStat(
                self.cfg.duration_window, self.cfg.buckets,
                keep_samples=self.cfg.duration_samples)
        if rs is not None:
            rs.observe(now, turnaround)

    def task_revoked(self, task) -> None:
        """Engine hook for drain revocations: administrative requeue, not
        a site failure — no error-window charge.  The registry entry (if
        any) stays: it tracks the live task object, whose `submit_time`
        is re-stamped when the engine re-places it."""
        self.tasks_revoked += 1

    # -- the cadence driver ---------------------------------------------
    def _tick(self) -> None:
        """One cadence interval: fold `Site.stats` deltas into the rolling
        windows, run the state machine, and — when due — the straggler
        scan and the stream emission.  Self-disarming: stops rescheduling
        once the watched engines go idle (re-armed by the next dispatch),
        so `SimClock.run()` terminates."""
        now = self.clock.now()
        window = self.cfg.window
        quiet = True
        volume = 0
        for eng in self._engines:
            for site in eng.balancer.sites:
                sh = self._sites.get(site.name)
                if sh is None:
                    sh = self._site_state(site)
                stats = site.stats
                done, failed = stats.completed, stats.failed
                d_fail = failed - sh.seen_failed
                d_all = (done - sh.seen_completed) + d_fail
                if d_all:
                    volume += d_all
                    if d_fail:
                        sh.last_fail_t = now
                    sh.outcomes.observe_bulk(now, d_all, float(d_fail))
                    sh.seen_completed = done
                    sh.seen_failed = failed
                state = sh.state
                if state in ("drained", "blacklisted"):
                    # a suspended site is not re-judged on its stale
                    # window: every tick would otherwise count as one
                    # more failed probe and escalate the backoff with no
                    # probe traffic having flowed.  The first tick after
                    # the suspension lapses judges the probe (fresh
                    # samples — plus window leftovers when the backoff
                    # is shorter than the window).
                    if now >= site.suspended_until:
                        self._evaluate(sh, now)
                elif d_all:
                    # a healthy site with no failure inside the window has
                    # windowed err == 0 exactly — the state machine cannot
                    # move it, so skip the windowed queries
                    if (state != "healthy"
                            or now - sh.last_fail_t <= window):
                        self._evaluate(sh, now)
                elif state != "healthy":
                    # degraded with no fresh completions: still let the
                    # window be judged once its samples expire
                    self._evaluate(sh, now)
                if d_fail or state != "healthy":
                    quiet = False
        if now >= self._next_scan and self.cfg.straggler_interval > 0.0:
            self._next_scan = now + self.cfg.straggler_interval
            self._scan(now)       # may push _next_scan further out
        if self._sink is not None and now >= self._next_emit:
            self._next_emit = now + self._emit_interval
            self.emit_line(now)
        if self._active():
            # normalize volume to completions per *bucket* interval so a
            # stretched tick doesn't un-stretch itself just by covering
            # more time
            if quiet and volume * self._tick_s < (self._stretch_min
                                                  * self._tick_cur):
                self._tick_cur = min(self._tick_cur * 2.0, self._tick_max)
            else:
                self._tick_cur = self._tick_s
            self.clock.schedule(self._tick_cur, self._tick)
        else:
            self._armed = False
            if self._running:
                # idle: everything left is resolved residue — release the
                # task references (§9 GC contract)
                self._running.clear()
                self._flagged.clear()

    def on_executor(self, svc, executor, ok: bool, now: float) -> None:
        """Falkon `_complete` hook: per-executor windowed error tracking;
        drains (suspends) individual executors whose windowed error rate
        crosses `executor_drain_error_rate` (None disables)."""
        thr = self.cfg.executor_drain_error_rate
        if thr is None:
            return
        key = (svc.name, executor.id)
        rs = self._exec_stats.get(key)
        if rs is None:
            self._exec_stats[key] = rs = RollingStat(self.cfg.window,
                                                     self.cfg.buckets)
        rs.observe(now, 0.0 if ok else 1.0)
        if (not ok and now >= executor.suspended_until
                and rs.count(now) >= self.cfg.executor_min_samples
                and rs.mean(now) >= thr):
            executor.suspended_until = now + self.cfg.executor_backoff
            self.executors_drained += 1
            if self.tracer is not None:
                self.tracer.event("executor_drained", now)

    def _on_event(self, kind: str, t: float, value: float) -> None:
        """Tracer event-stream subscriber: windowed rates for alert-worthy
        component events (pool worker errors land here on the real path,
        where failures are seen by the pool before the engine)."""
        if kind != "worker_error":
            return
        rs = self._alerts.get(kind)
        if rs is None:
            self._alerts[kind] = rs = RollingStat(self.cfg.window,
                                                  self.cfg.buckets)
        rs.observe(t, value)

    # -- state machine --------------------------------------------------
    def _site_state(self, site) -> _SiteHealth:
        sh = self._sites.get(site.name)
        if sh is None:
            self._sites[site.name] = sh = _SiteHealth(site, self.cfg)
        return sh

    def _evaluate(self, sh: _SiteHealth, now: float) -> None:
        cfg = self.cfg
        n = sh.outcomes.count(now)
        if n < cfg.min_samples:
            return
        err = sh.outcomes.total(now) / n
        site = sh.site
        state = sh.state
        if state in ("drained", "blacklisted"):
            # only reached once the suspension has lapsed (the tick skips
            # suspended sites): the samples are fresh post-probe traffic,
            # plus pre-drain leftovers when the backoff is shorter than
            # the window — those age out within one window of the probe
            if err <= cfg.recover_error_rate:
                sh.consecutive_drains = 0
                site.derate = 1.0
                self._transition(sh, now, "healthy",
                                 f"probe ok err={err:.3f} n={n}")
            elif err >= cfg.drain_error_rate:
                sh.consecutive_drains += 1
                to = ("blacklisted" if state == "blacklisted"
                      or err >= cfg.blacklist_error_rate
                      or sh.consecutive_drains >= cfg.blacklist_after_drains
                      else "drained")
                self._suspend(sh, now, to, err, n)
            return
        if err >= cfg.blacklist_error_rate:
            sh.consecutive_drains += 1
            self._suspend(sh, now, "blacklisted", err, n)
        elif err >= cfg.drain_error_rate:
            sh.consecutive_drains += 1
            self._suspend(sh, now, "drained", err, n)
        elif err >= cfg.degrade_error_rate:
            if state != "degraded":
                site.derate = cfg.degrade_derate
                self._transition(sh, now, "degraded",
                                 f"err={err:.3f} n={n}")
        elif state == "degraded":
            site.derate = 1.0
            self._transition(sh, now, "healthy", f"err={err:.3f} n={n}")

    def _suspend(self, sh: _SiteHealth, now: float, to_state: str,
                 err: float, n: int) -> None:
        cfg = self.cfg
        site = sh.site
        if to_state == "blacklisted":
            backoff = cfg.blacklist_backoff
        else:
            backoff = (cfg.drain_backoff
                       * cfg.backoff_factor ** max(
                           0, sh.consecutive_drains - 1))
        # never shrink an existing suspension; the balancer and the
        # federation stealer both already skip suspended sites
        site.suspended_until = max(site.suspended_until, now + backoff)
        site.derate = 1.0
        revoked = 0
        if cfg.revoke_on_drain:
            svc = getattr(site.provider, "service", None)
            if svc is not None and hasattr(svc, "drain_queued"):
                revoked = svc.drain_queued()
                sh.revoked += revoked
        self._transition(sh, now, to_state,
                         f"err={err:.3f} n={n} backoff={backoff:g}"
                         + (f" revoked={revoked}" if revoked else ""))
        # when the suspension lapses (the probe), held tasks must be able
        # to flow again even if no completion occurs to trigger a drain
        # pass — and if *every* site is suspended the engine would
        # otherwise deadlock on its pending queue
        for eng in self._engines:
            self.clock.schedule(backoff + 1e-9, eng.poke)

    def _transition(self, sh: _SiteHealth, now: float, to_state: str,
                    reason: str) -> None:
        rec = {"t": round(now, 9), "site": sh.site.name,
               "from": sh.state, "to": to_state, "reason": reason}
        sh.state = to_state
        sh.site.health_state = to_state
        self.transitions.append(rec)
        if self.tracer is not None:
            self.tracer.event(f"health_{to_state}", now)

    # -- straggler scan (tick sub-cadence) ------------------------------
    def _scan(self, now: float) -> None:
        cfg = self.cfg
        running = self._running
        if not running:
            return
        # Drain resolved entries off the head: completions never touch
        # the registry (§13 hot-path contract), so each admitted task is
        # popped here exactly once — O(1) amortized per admission.  The
        # deque is in dispatch order (`submit_time` is stamped at
        # `_place`), so after the drain the head region holds the oldest
        # live tasks; a retried task's entry stays mid-deque tracking
        # the live object with its re-stamped (younger) submit time.
        flagged = self._flagged
        while running:
            task = running[0]
            if not task.output.resolved:
                break
            running.popleft()
            if flagged:
                flagged.discard(task.id)
        # Cheap pre-check: the first live unflagged entry is the oldest
        # candidate — if even it is younger than the smallest cached
        # threshold, nothing can be flagged and the scan skips entirely.
        head_age = None
        for task in running:
            if task.output.resolved or task.id in flagged:
                continue
            head_age = now - task.submit_time
            break
        if head_age is None:
            return
        slack = self._thr_floor - head_age
        if slack > 0.0:
            # nothing can be flagged before the oldest candidate's age
            # reaches the cached floor (ages grow at 1 s/s; every other
            # task is younger) — push the next scan out to that horizon,
            # capped so a shrinking p95 is picked up within one duration
            # window.  On a healthy run successive scans space out
            # geometrically instead of paying the walk at tick cadence.
            ns = now + min(slack, cfg.duration_window)
            if ns > self._next_scan:
                self._next_scan = ns
            return
        # Recompute per-key thresholds only on demand — when the oldest
        # candidate has outgrown the cached floor.  The floor goes stale
        # only downward-late (a shrinking p95 delays a flag until the
        # task's age crosses the old floor — ages grow monotonically, so
        # no flag is ever lost).  With no key at `min_samples` yet the
        # recompute is sort-free and retried at duration-bucket cadence.
        self._thr_at = now
        thresholds = self._thresholds = {}
        min_thr = None
        for key, rs in self._durations.items():
            if rs.count(now) < cfg.min_samples:
                continue
            thr = max(cfg.straggler_min_s,
                      cfg.straggler_factor * rs.percentile(0.95, now))
            thresholds[key] = thr
            if min_thr is None or thr < min_thr:
                min_thr = thr
        # no key has enough samples yet -> 0.0 keeps the pre-check open
        self._thr_floor = min_thr if min_thr is not None else 0.0
        if not thresholds:
            ns = now + max(cfg.straggler_interval, self._thr_refresh)
            if ns > self._next_scan:
                self._next_scan = ns
            return
        unknown = 0
        for task in running:
            if task.output.resolved:
                continue    # mid-deque stale; drains once it reaches head
            in_flight = now - task.submit_time
            if in_flight <= min_thr:
                break
            tid = task.id
            if tid in flagged:
                continue
            key = task.vmap_key
            if key is None:
                key = (task.app, task.name)
            threshold = thresholds.get(key)
            if threshold is None:
                # this key can't flag until it accumulates samples; a
                # long prefix of such tasks (a cold fan-out waiting in a
                # provider queue) must not turn the scan O(running) —
                # bail and retry next scan, when the prefix has either
                # completed or earned a threshold
                unknown += 1
                if unknown > 64:
                    break
                continue
            if in_flight <= threshold:
                continue
            self._flagged.add(tid)
            self.stragglers_flagged += 1
            site = task.site
            if site is not None:
                self._site_state(site).stragglers += 1
            self.straggler_log.append(
                (now, task.name, site.name if site else "", in_flight,
                 threshold))
            if self.tracer is not None:
                self.tracer.event("straggler", now,
                                  in_flight - threshold)
            if self.on_straggler is not None:
                # re-dispatch hint: the callback may cancel/clone the
                # task; the monitor itself only flags
                self.on_straggler(task, in_flight, threshold)

    # -- metrics stream --------------------------------------------------
    def _active(self) -> bool:
        # engine counters, not the registry: resolved entries linger in
        # `_running` until drained and must not keep the tick alive.
        # Summed across shards, not tested per shard — a stolen task
        # completes on the thief, leaving the victim's own inflight()
        # positive and the thief's negative forever (they only balance
        # in aggregate), and a per-shard test would keep ticking an idle
        # federation.
        return sum(eng.inflight() for eng in self._engines) > 0

    def emit_line(self, now: float | None = None) -> dict:
        """Append one metrics-stream line to the sink (and return it)."""
        if now is None:
            now = self.clock.now()
        self._check_watermarks(now)
        line = self.snapshot_line(now)
        if self._sink is not None:
            self._sink.write(json.dumps(line, sort_keys=True) + "\n")
            flush = getattr(self._sink, "flush", None)
            if flush is not None:
                flush()
            self.lines_emitted += 1
        return line

    def _check_watermarks(self, now: float) -> None:
        cap = sum(e.pool_capacity() for e in self._engines)
        if cap <= 0 or self.tracer is None:
            return
        backlog = sum(e.ready_backlog() for e in self._engines)
        if not self._bp_high:
            if backlog > self.cfg.queue_high_watermark * cap:
                self._bp_high = True
                self.tracer.event("backpressure_high", now, backlog)
        elif backlog < self.cfg.queue_low_watermark * cap:
            self._bp_high = False
            self.tracer.event("backpressure_low", now, backlog)

    def _site_entry(self, sh: _SiteHealth, now: float) -> dict:
        site = sh.site
        o = sh.outcomes
        n = o.count(now)
        errs = o.total(now)
        svc = getattr(site.provider, "service", None)
        queue = (len(svc.queue) + svc._parked) if svc is not None \
            and hasattr(svc, "queue") else 0
        return {
            "state": sh.state,
            "error_rate": errs / n if n else 0.0,
            "window_completions": n,
            "tasks_per_s": (n - errs) / o.window,
            "latency_ewma_s": sh.lat_ewma,
            "latency_p95_s": sh.latency.percentile(0.95, now),
            "outstanding": site.outstanding,
            "capacity": site.capacity,
            "utilization": (site.outstanding / site.capacity
                            if site.capacity else 0.0),
            "queue": queue,
            "stragglers": sh.stragglers,
            "revoked": sh.revoked,
            "suspended_for_s": max(0.0, site.suspended_until - now),
        }

    def snapshot_line(self, now: float | None = None) -> dict:
        """One metrics-stream record: per-site health + engine backlog +
        tracer windowed event rates + registry component snapshot."""
        if now is None:
            now = self.clock.now()
        line = {
            "schema": METRICS_STREAM_SCHEMA,
            "t": now,
            "sites": {name: self._site_entry(sh, now)
                      for name, sh in sorted(self._sites.items())},
            "backlog": sum(e.ready_backlog() for e in self._engines),
            "inflight": sum(e.inflight() for e in self._engines),
            # tracked registry size (may exceed live in-flight between
            # prunes; bounded by straggler_track_cap)
            "tracked": len(self._running),
            "stragglers": self.stragglers_flagged,
            "revoked": self.tasks_revoked,
            "transitions": len(self.transitions),
        }
        if self._alerts:
            line["alerts"] = {k: rs.snapshot(now)
                              for k, rs in sorted(self._alerts.items())}
        if self.tracer is not None and hasattr(self.tracer, "event_rates"):
            line["events"] = self.tracer.event_rates(now)
        if self.registry is not None:
            line["components"] = self.registry.snapshot()
        return line

    # -- inspection ------------------------------------------------------
    def states(self) -> dict:
        """Current per-site health state, e.g. ``{"site0": "healthy"}``."""
        return {name: sh.state for name, sh in sorted(self._sites.items())}

    def transition_log_json(self) -> str:
        """The exact state-change log as canonical JSON — byte-identical
        across `SimClock` replays of the same workflow (the determinism
        acceptance check)."""
        return json.dumps(self.transitions, sort_keys=True)

    def metrics(self) -> dict:
        """Registry-compatible bounded snapshot."""
        now = self.clock.now()
        return {
            "sites": {name: self._site_entry(sh, now)
                      for name, sh in sorted(self._sites.items())},
            "transitions": len(self.transitions),
            "stragglers_flagged": self.stragglers_flagged,
            "tasks_revoked": self.tasks_revoked,
            "executors_drained": self.executors_drained,
            "lines_emitted": self.lines_emitted,
        }
