"""Multi-engine federation: shard one workflow across N engines
(DESIGN.md §8).

The paper scales one Swift/Karajan engine feeding one Falkon service; its
own application campaigns (§5 — MolDyn, fMRI) want *many* cooperating
engines.  The binding constraint is the dispatcher: Falkon's measured 487
tasks/s (§4) is a per-service ceiling, so past ~500 short tasks/s one
engine cannot keep any pool busy no matter how large.  Federation shards
the dataflow graph across N `Engine` shards — each a full engine with its
own `LoadBalancer`, sites, and (typically) one Falkon service per pod —
giving N dispatchers, with three cross-shard mechanisms:

  * `Mailbox`          — cross-shard future delivery: a consumer shard
                         blocks on a local proxy that resolves in one
                         coalesced clock event when the producing shard
                         completes (optionally after a delivery latency),
                         never on the producer's internal state.
  * `WorkStealer`      — migrates *pending-ready* tasks (the engine's held
                         ready queue) from overloaded shards to idle ones:
                         steal-half of the victim's deque in one bounded
                         batch, amortized O(1) per task, O(shards) per
                         steal event, never a per-task scan.
  * `ShardedDataLayer` — the data-diffusion holder index (§7) shards with
                         the engines: per-shard holder maps plus a small
                         cross-shard `ShardDirectory`, so locality-driven
                         dispatch keeps working after a steal — a migrated
                         task re-routes to holders in its *new* shard or
                         pays the staging cost `StagingCostModel` prices
                         (the stealer reports those restage bytes through
                         bounded `StreamStat` metrics).

Scale contracts: per-task federation overhead is O(1) (one partitioner
hash, one ownership-dict update, O(args) proxy checks); steal passes cost
O(shards + batch); mailbox flushes are one event per delivery window; all
federation metrics are bounded counters / `StreamStat` reservoirs.
Everything is deterministic under `SimClock` — the default partitioner
uses crc32, not Python's seeded `hash`.

`FederatedEngine` duck-types `Engine` (`submit`, `run`, `clock`,
`tasks_completed`, `stats`), so `Workflow` — including `foreach`
expansion at runtime — runs over a federation transparently.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional
from zlib import crc32

from repro_torch.core.datastore import (DataLayer, ShardDirectory, SharedStore,
                                  StagingCostModel, inputs_of)
from repro_torch.core.engine import Engine
from repro_torch.core.futures import DataFuture
from repro_torch.core.metrics import StreamStat
from repro_torch.core.simclock import Clock, SimClock

__all__ = [
    "FederatedEngine", "Mailbox", "MailboxTransport", "QueueTransport",
    "WorkStealer", "ShardedDataLayer",
    "hash_partitioner", "skewed_partitioner", "inputs_partitioner",
]


def hash_partitioner(key: str, n_shards: int) -> int:
    """Default partitioner: stable hash of the task key.  crc32, not
    `hash()` — Python string hashing is per-process randomized and would
    break SimClock replay determinism."""
    return crc32(key.encode()) % n_shards


def skewed_partitioner(heavy_frac: float, heavy_shard: int = 0) -> Callable:
    """A deliberately imbalanced partitioner: `heavy_frac` of all keys land
    on `heavy_shard`, the rest spread over the other shards.  Used by the
    federation benchmark/tests to exercise work stealing."""
    cut = int(heavy_frac * 1000)

    def part(key: str, n_shards: int) -> int:
        h = crc32(key.encode())
        if h % 1000 < cut or n_shards <= 1:
            return heavy_shard % n_shards
        other = (h // 1000) % (n_shards - 1)
        return other if other < heavy_shard else other + 1

    return part


def inputs_partitioner(key: str, n_shards: int, inputs: tuple = ()) -> int:
    """Affinity-aware partitioner (ROADMAP: affinity partitioning, first
    half): tasks are keyed on their declared `DataObject` inputs, so tasks
    sharing an input land on the same shard — that shard's data layer
    caches the file once instead of every shard staging its own replica,
    and cross-shard restaging after steals drops with it.

    The anchor is the *largest* declared input (the one worth co-locating
    for), ties broken by name; tasks with no declared inputs fall back to
    the crc32 key hash, identical to `hash_partitioner`.  O(inputs) per
    task, deterministic (crc32, not `hash()`).
    """
    if inputs:
        anchor = max(inputs, key=lambda o: (o.size, o.name))
        return crc32(anchor.name.encode()) % n_shards
    return crc32(key.encode()) % n_shards


# `FederatedEngine.submit` passes the task's normalized input tuple only to
# partitioners that declare they want it, so plain `(key, n)` partitioners
# keep working unchanged.
inputs_partitioner.wants_inputs = True


class MailboxTransport:
    """Delivery mechanism behind a `Mailbox` (DESIGN.md §10).

    The default (no transport) models delivery: a coalesced clock flush
    after a simulated latency.  A transport replaces the model with a real
    hand-off — messages cross its medium and are *delivered* on the
    consumer's clock thread via the `deliver` callback the mailbox binds.
    """

    def bind(self, clock: Clock, deliver: Callable) -> None:
        raise NotImplementedError

    def send(self, msg) -> None:
        raise NotImplementedError


class QueueTransport(MailboxTransport):
    """Queue-backed in-process transport (DESIGN.md §10): messages cross a
    thread-safe `queue.SimpleQueue` and are drained on the consumer's clock
    thread through `Clock.post`, one coalesced drain per burst.

    Under `RealClock` this is true cross-thread-capable delivery (the post
    wakes the event loop even mid-wait); under `SimClock` the same code
    path runs deterministically (`post` degrades to `schedule(0, ...)`),
    which is how the delivery/failure tests pin its semantics.  Example::

        fed = FederatedEngine(4, clock=RealClock(), transport="queue")
    """

    def __init__(self):
        import queue as _queue
        import threading as _threading
        self._q = _queue.SimpleQueue()
        self._empty = _queue.Empty
        self._lock = _threading.Lock()
        self._wake_pending = False
        self._clock: Clock | None = None
        self._deliver: Callable | None = None
        self.sends = 0
        self.drains = 0

    def bind(self, clock: Clock, deliver: Callable) -> None:
        self._clock = clock
        self._deliver = deliver

    def send(self, msg) -> None:
        self._q.put(msg)
        # coalesce wakeups: one drain event per burst.  The drain clears
        # the flag *before* reading the queue, so a sender that observes
        # the flag still set is guaranteed its message is picked up by the
        # drain that clears it.  `sends` is bumped under the same lock:
        # send() runs on producer threads under RealClock, and an unlocked
        # += loses increments under contention.
        with self._lock:
            self.sends += 1
            if self._wake_pending:
                return
            self._wake_pending = True
        self._clock.post(self._drain)

    def _drain(self) -> None:
        with self._lock:
            self._wake_pending = False
        self.drains += 1          # clock thread only — no lock needed
        batch = []
        while True:
            try:
                batch.append(self._q.get_nowait())
            except self._empty:
                break
        if batch:
            self._deliver(batch)


class Mailbox:
    """Cross-shard completion delivery for one consumer shard.

    Producers post (proxy, source-future) pairs at resolution time; each
    message is delivered no earlier than `latency` simulated seconds after
    its post (the modeled inter-pod transport time) and messages that come
    due at the same flush share one clock event — a same-instant burst of
    cross-shard completions costs one event, not one per edge, while a
    message posted late in an open window still waits its *own* full
    latency (the flush re-schedules for the not-yet-due tail).  Failures
    propagate: a failed source fails its proxies, and the consumer
    engine's upstream-failure path handles the rest.

    With a `MailboxTransport` attached (e.g. `QueueTransport`,
    DESIGN.md §10) delivery is *real* instead of modeled: `post` hands the
    message to the transport and the transport's drain delivers it on the
    consumer's clock thread; `latency` is then whatever the transport
    actually takes and the parameter is ignored.
    """

    def __init__(self, clock: Clock, shard_id: int, latency: float = 0.0,
                 transport: MailboxTransport | None = None, tracer=None):
        self.clock = clock
        self.shard_id = shard_id
        self.latency = latency
        self.transport = transport
        self.tracer = tracer
        if transport is not None:
            transport.bind(clock, self._deliver)
        self._queue: deque = deque()    # (ready_at, proxy, src), time-sorted
        self._flush_at = None
        self.messages = 0
        self.flushes = 0
        self.batch_stat = StreamStat(cap=256)   # messages per flush
        # fid -> local future, for *envelope* delivery: a transport that
        # crosses a process boundary cannot carry future objects, so the
        # producer side sends (fid, ok, payload) and the consumer registers
        # the future awaiting each fid here (DESIGN.md §14).  Entries are
        # popped on delivery, so the map is bounded by in-flight envelopes.
        self._awaiting: dict[int, DataFuture] = {}

    def post(self, proxy: DataFuture, src: DataFuture) -> None:
        self.messages += 1
        if self.transport is not None:
            self.transport.send((proxy, src))
            return
        now = self.clock.now()
        # posts arrive in clock order, so the deque stays sorted by ready_at
        self._queue.append((now + self.latency, proxy, src))
        if self._flush_at is None:
            self._flush_at = now + self.latency
            self.clock.schedule(self.latency, self._flush)

    def register_proxy(self, fid: int, fut: DataFuture) -> None:
        """Bind a local future to a remote fid: the next `(fid, ok,
        payload)` envelope delivered through this mailbox resolves it."""
        self._awaiting[fid] = fut

    def _deliver(self, batch: list) -> None:
        """Transport drain target: resolve a batch of delivered messages on
        the consumer's clock thread (same failure propagation as `_flush`).

        Two message shapes: in-process transports carry `(proxy, src)`
        future pairs; process-boundary transports carry pickle-safe
        `(fid, ok, payload)` envelopes resolved against `register_proxy`
        registrations (unknown fids are ignored — the registration may
        have been dropped by a shard death)."""
        for msg in batch:
            if len(msg) == 2:
                proxy, src = msg
                if src.failed:
                    proxy.set_error(src._error)
                else:
                    proxy.set(src.get())
            else:
                # envelopes never pass through post(), so count them here
                self.messages += 1
                fid, ok, payload = msg
                fut = self._awaiting.pop(fid, None)
                if fut is None or fut.done:
                    continue
                if ok:
                    fut.set(payload)
                else:
                    fut.set_error(payload)
        self.flushes += 1
        self.batch_stat.observe(self.clock.now(), len(batch))
        if self.tracer is not None:
            self.tracer.event("mailbox_flush", self.clock.now(), len(batch))

    def _flush(self) -> None:
        self._flush_at = None
        queue = self._queue
        now = self.clock.now()
        # deliver everything already due; resolving proxies can trigger
        # submissions that post new messages — those land behind the due
        # prefix with a strictly later ready_at, so the loop terminates
        batch = 0
        while queue and queue[0][0] <= now + 1e-12:
            _, proxy, src = queue.popleft()
            batch += 1
            if src.failed:
                proxy.set_error(src._error)
            else:
                proxy.set(src.get())
        self.flushes += 1
        self.batch_stat.observe(now, batch)
        if self.tracer is not None:
            self.tracer.event("mailbox_flush", now, batch)
        if queue and (self._flush_at is None or queue[0][0] < self._flush_at):
            # undelivered tail (posted mid-window): wake when its own
            # latency elapses.  A mid-flush post may already have scheduled
            # a wake, but possibly later than this head needs — an extra
            # earlier event is harmless (a flush delivers only what is due)
            self._flush_at = queue[0][0]
            self.clock.schedule(max(0.0, queue[0][0] - now), self._flush)

    def metrics(self) -> dict:
        return {
            "messages": self.messages,
            "flushes": self.flushes,
            "batch": self.batch_stat.summary(),
        }


class WorkStealer:
    """Steal-half work migration between federation shards.

    A steal pass runs as one coalesced clock event (flag-guarded `poke`),
    scans the O(shards) load vector, and for each idle thief (no held
    backlog, free balancer capacity — the `LoadBalancer.idle_slots` steal
    interface) migrates half of the most-loaded shard's pending-ready
    deque, bounded by `max_batch`, in one batch.  Tasks are popped from
    the *back* of the victim's deque (newest-ready first), so the victim
    keeps draining its oldest work in order; migration itself is
    `thief._dispatch(task)` — the thief's balancer, throttle, and data
    layer take over from there.

    Steal-induced restage cost: with a `ShardedDataLayer` attached, each
    migrated task's inputs are priced against the cross-shard directory
    (held in the victim shard but not the thief's -> restage bytes) and
    reported through a bounded `StreamStat` — an O(inputs) lookup per
    migrated task, no executor or task scans.

    Health interplay (DESIGN.md §13): a drained/blacklisted shard is never
    a thief — thief eligibility requires `LoadBalancer.idle_slots` > 0 and
    that already skips suspended sites.  It *is* the natural victim: its
    unplaceable ready work accumulates in `_pending` (via `notify_backlog`)
    and migrates to healthy shards, which is how the federation routes
    around a bad shard with no health-specific code here.
    """

    def __init__(self, clock: Clock, min_batch: int = 2,
                 max_batch: int = 4096, interval: float = 0.0,
                 victim_policy: str = "load"):
        if victim_policy not in ("load", "directory"):
            raise ValueError(f"unknown victim_policy {victim_policy!r}; "
                             f"expected 'load' or 'directory'")
        self.clock = clock
        self.min_batch = max(1, min_batch)
        self.max_batch = max_batch
        self.interval = interval
        self.victim_policy = victim_policy
        self.fed: Optional["FederatedEngine"] = None
        self._scheduled = False
        self.steals = 0              # batches migrated
        self.tasks_stolen = 0
        self.passes = 0              # rebalance events (incl. no-ops)
        self.restage_bytes_est = 0.0
        self.batch_stat = StreamStat(cap=256)     # tasks per steal batch
        self.restage_stat = StreamStat(cap=256)   # restage bytes per batch

    def attach(self, fed: "FederatedEngine") -> None:
        self.fed = fed

    def poke(self) -> None:
        """Request a steal pass; coalesced — at most one scheduled at a
        time, so pokes are O(1) however often load changes."""
        if not self._scheduled:
            self._scheduled = True
            self.clock.schedule(self.interval, self._rebalance)

    def _rebalance(self) -> None:
        fed = self.fed
        if fed is None:
            self._scheduled = False
            return
        self.passes += 1
        now = self.clock.now()
        shards = fed.shards
        sdl = fed.data_layer
        for thief in shards:
            if thief._pending or thief.balancer.idle_slots(now) <= 0:
                continue
            victim = self._pick_victim(shards, thief, sdl)
            if victim is None or victim is thief \
                    or len(victim._pending) < self.min_batch:
                continue
            n = min(len(victim._pending) // 2, self.max_batch)
            if n <= 0:
                continue
            batch = victim._pending.steal(n)
            moved = []
            restage = 0.0
            for task, excl in batch:
                # heterogeneous shards: only migrate what the thief can run
                if not thief.balancer.any_valid(task.app):
                    victim._pending.append((task, excl))
                    continue
                moved.append(task)
                if sdl is not None and task.inputs:
                    restage += sdl.restage_estimate(
                        task.inputs, victim.shard_id, thief.shard_id)
            if not moved:
                continue
            self.steals += 1
            self.tasks_stolen += len(moved)
            self.batch_stat.observe(now, len(moved))
            tr = getattr(fed, "tracer", None)
            if tr is not None:
                tr.event("steal", now, len(moved))
            if sdl is not None:
                self.restage_bytes_est += restage
                self.restage_stat.observe(now, restage)
            for task in moved:
                # exclude_site names are victim-local; the thief's balancer
                # places (or holds) the task fresh
                thief._dispatch(task)
        self._scheduled = False

    # -- victim selection ----------------------------------------------
    def _pick_victim(self, shards, thief, sdl):
        """Choose which shard the thief steals from.

        ``"load"`` (default) is the original policy, byte-identical under
        SimClock: the single most-loaded shard.  ``"directory"`` is
        locality-aware (needs a `ShardedDataLayer`): among shards whose
        backlog is within 2x of the maximum (so stealing still fixes the
        imbalance), prefer the one whose sampled pending inputs the thief
        would re-stage *least*, priced through the cross-shard directory.
        Cost: O(shards) + O(candidates x sample x inputs) directory
        probes per steal pass — bounded by the sample cap, never a full
        queue scan."""
        if self.victim_policy == "load" or sdl is None:
            return max(shards, key=lambda s: len(s._pending))
        maxload = max(len(s._pending) for s in shards)
        floor = max(self.min_batch, maxload // 2)
        best, best_cost = None, None
        for s in shards:
            if s is thief or len(s._pending) < floor:
                continue
            cost = self._restage_sample(s, thief, sdl)
            # ties (incl. the all-zero case) break toward higher load,
            # which is what makes the policy degrade to "load" gracefully
            rank = (cost, -len(s._pending))
            if best is None or rank < best_cost:
                best, best_cost = s, rank
        return best

    def _restage_sample(self, victim, thief, sdl) -> float:
        """Average restage bytes over a bounded sample of the victim's
        newest pending-ready tasks (the ones a steal would take)."""
        sample = victim._pending.peek(8)
        if not sample:
            return 0.0
        total = 0.0
        for task in sample:
            if task.inputs:
                total += sdl.restage_estimate(
                    task.inputs, victim.shard_id, thief.shard_id)
        return total / len(sample)

    def metrics(self) -> dict:
        return {
            "victim_policy": self.victim_policy,
            "steals": self.steals,
            "tasks_stolen": self.tasks_stolen,
            "passes": self.passes,
            "restage_bytes_est": self.restage_bytes_est,
            "batch": self.batch_stat.summary(),
            "restage_per_batch": self.restage_stat.summary(),
        }


class ShardedDataLayer:
    """Data-diffusion layer sharded alongside the engines (DESIGN.md §8).

    One `DataLayer` per shard — each bound to that shard's Falkon service
    via ``FalkonService(data_layer=sdl.layer(i))`` — all sharing one
    `SharedStore` and `StagingCostModel`, plus one cross-shard
    `ShardDirectory`.  Per-dispatch holder lookups stay entirely
    shard-local (same O(inputs x probe_limit) contract as §7); the
    directory only answers the federation-level question "which shards
    hold X", used to price steal-induced restaging.
    """

    def __init__(self, n_shards: int, shared: SharedStore | None = None,
                 cost: StagingCostModel | None = None,
                 cache_capacity: float = 1e9, policy="lru", **layer_kw):
        self.shared = shared or SharedStore()
        self.cost = cost or StagingCostModel()
        self.directory = ShardDirectory()
        self.shards: list[DataLayer] = []
        for i in range(n_shards):
            dl = DataLayer(self.shared, self.cost,
                           cache_capacity=cache_capacity, policy=policy,
                           **layer_kw)
            dl.shard_id = i
            dl.directory = self.directory
            self.shards.append(dl)

    def layer(self, shard_id: int) -> DataLayer:
        return self.shards[shard_id]

    def restage_estimate(self, inputs, src: int, dst: int) -> float:
        """Bytes a task migrated src -> dst must re-stage: inputs held
        somewhere in the source shard but nowhere in the destination shard
        (O(inputs) cross-shard directory probes — this is the query the
        directory exists for; per-executor holder maps stay shard-local)."""
        if src == dst:
            return 0.0
        directory = self.directory
        bytes_ = 0.0
        for obj in inputs:
            if directory.holds(obj.name, src) and \
                    not directory.holds(obj.name, dst):
                bytes_ += obj.size
        return bytes_

    def metrics(self) -> dict:
        per_shard = [dl.metrics() for dl in self.shards]
        return {
            "directory_objects": len(self.directory),
            "hits": sum(m["hits"] for m in per_shard),
            "misses": sum(m["misses"] for m in per_shard),
            "bytes_staged": sum(m["bytes_staged"] for m in per_shard),
            "bytes_local": sum(m["bytes_local"] for m in per_shard),
            "shards": per_shard,
        }


class FederatedEngine:
    """Shard one dataflow graph across N `Engine`s sharing a clock.

    Duck-types the `Engine` surface the DSL uses (`submit`, `run`,
    `clock`, aggregate counters), so ``Workflow("w", FederatedEngine(4))``
    — `foreach`, `gather`, `when`, atomic procedures — works unchanged.

    * **Partitioning** — each submission is routed by
      ``partitioner(task_key, n_shards)`` (default: crc32 hash of the
      key).  Keys are federation-assigned (`name#counter`) unless the
      caller passes one, so partitioning is deterministic and pluggable
      (e.g. `skewed_partitioner` for imbalance experiments, or a
      domain partitioner that keeps a molecule's pipeline on one shard).
    * **Cross-shard futures** — an argument future produced by another
      shard is replaced by a shard-local proxy delivered through the
      consumer shard's `Mailbox`: the consumer blocks only on the
      producing shard's completion event (plus `delivery_latency`), and
      one proxy is shared by all consumers on the same shard.  Futures
      with no owning shard — workflow combinators (`gather` / `foreach` /
      `when`) resolve driver-side — cross the driver->shard transport
      the same way, so high-fan-in joins also pay delivery latency and
      count in `cross_shard_edges`.  Ownership bookkeeping is dropped as
      futures resolve, so the map is bounded by *in-flight* futures, not
      by workflow size.
    * **Work stealing** — shards hold excess ready work in their pending
      queue (`_hold_excess`); `notify_idle`/`notify_backlog` hooks poke
      the `WorkStealer`, which migrates steal-half batches to idle
      shards.  Pass ``steal=False`` (or ``stealer=None`` explicitly) for
      a partition-only federation.
    """

    def __init__(self, shards: int | list[Engine],
                 clock: Clock | None = None,
                 partitioner: Callable[[str, int], int] | None = None,
                 data_layer: ShardedDataLayer | None = None,
                 stealer: WorkStealer | None = None, steal: bool = True,
                 victim_policy: str = "load",
                 delivery_latency: float = 0.0,
                 transport: str | Callable[[], MailboxTransport]
                 | None = None,
                 engine_kwargs: dict | None = None,
                 tracer=None):
        # observability (DESIGN.md §12): one shared tracer across every
        # shard — spans carry their shard id, mailbox flushes and steals
        # land as component events, and the clock's deterministic event
        # order keeps the merged stream reproducible under SimClock
        self.tracer = tracer
        # online health (DESIGN.md §13): set by `HealthMonitor.watch(fed)`,
        # which also watches every shard engine; drained shards then stop
        # being steal thieves via the suspended-site seam in `idle_slots`
        self.health = None
        if isinstance(shards, int):
            if shards < 1:
                raise ValueError("need at least one shard")
            self.clock = clock or SimClock()
            kw = dict(engine_kwargs or {})
            if tracer is not None:
                kw.setdefault("tracer", tracer)
            shards = [Engine(self.clock, **kw) for _ in range(shards)]
        else:
            shards = list(shards)
            if not shards:
                raise ValueError("need at least one shard")
            self.clock = clock or shards[0].clock
            for eng in shards:
                if eng.clock is not self.clock:
                    raise ValueError("all shards must share one clock")
                if tracer is not None and eng.tracer is None:
                    eng.tracer = tracer
        self.shards = shards
        self.partitioner = partitioner or hash_partitioner
        self._partition_on_inputs = getattr(self.partitioner,
                                            "wants_inputs", False)
        self.data_layer = data_layer
        # transport=None: latency-simulated delivery (one coalesced flush
        # per window).  "queue" (or a factory returning MailboxTransport
        # instances): real queue-backed delivery per consumer shard —
        # delivery_latency is then ignored (DESIGN.md §10).
        if transport == "queue":
            transport = QueueTransport
        elif isinstance(transport, str):
            raise ValueError(f"unknown mailbox transport {transport!r}; "
                             f"expected 'queue', a factory, or None")
        self.mailboxes = [
            Mailbox(self.clock, i, delivery_latency,
                    transport=transport() if transport is not None else None,
                    tracer=tracer)
            for i in range(len(shards))]
        self.stealer = stealer if stealer is not None else (
            WorkStealer(self.clock, victim_policy=victim_policy)
            if steal else None)
        if self.stealer is not None:
            self.stealer.attach(self)
        for i, eng in enumerate(shards):
            eng.shard_id = i
            eng._federation = self
            eng._hold_excess = True
        self.tasks_submitted = 0
        self.cross_shard_edges = 0
        self._owner: dict[int, int] = {}          # future id -> shard
        self._proxies: dict[tuple, DataFuture] = {}
        # aggregate backpressure waiters (DESIGN.md §9): shard completions
        # delegate the wake check here so the streaming frontier keys on
        # federation-wide saturation, not one shard's
        self._bp_waiters: list = []

    # ------------------------------------------------------------------
    def submit(self, name: str, fn=None, args: list | None = None,
               duration: float | None = None, app: str | None = None,
               durable: bool = False, key: str | None = None,
               vmap_key=None, inputs=None) -> DataFuture:
        args = args or []
        if key is None:
            key = f"{name}#{self.tasks_submitted}"
        self.tasks_submitted += 1
        if self._partition_on_inputs:
            # normalize once here (the shard engine skips re-normalizing
            # tuples), so the affinity partitioner sees the DataObjects
            if type(inputs) is not tuple:
                inputs = inputs_of(inputs, *args) if inputs is not None \
                    else ()
            shard = self.partitioner(key, len(self.shards), inputs)
        else:
            shard = self.partitioner(key, len(self.shards))
        routed = args
        for idx, a in enumerate(args):
            if isinstance(a, DataFuture) and not a.done:
                # owner None = a workflow-combinator future (gather /
                # foreach / when run driver-side, not on a shard): those
                # joins cross the driver->shard transport too, so they
                # proxy through the consumer's mailbox exactly like a
                # future produced by another shard
                if self._owner.get(a.id) != shard:
                    if routed is args:
                        routed = list(args)
                    routed[idx] = self._proxy(a, shard)
        out = self.shards[shard].submit(
            name, fn, routed, duration=duration, app=app, durable=durable,
            key=key, vmap_key=vmap_key, inputs=inputs)
        if not out.done:                 # restart-log hits resolve eagerly
            self._owner[out.id] = shard
            out.on_done(self._forget)
        return out

    def _forget(self, f: DataFuture) -> None:
        self._owner.pop(f.id, None)

    def _proxy(self, fut: DataFuture, consumer: int) -> DataFuture:
        """Shard-local stand-in for a future owned by another shard; one
        proxy per (future, consumer shard), delivered via the mailbox."""
        pkey = (fut.id, consumer)
        p = self._proxies.get(pkey)
        if p is None:
            p = DataFuture(name=f"{fut.name}@shard{consumer}")
            self._proxies[pkey] = p
            self.cross_shard_edges += 1
            mbox = self.mailboxes[consumer]
            fut.on_done(lambda f, p=p, m=mbox: m.post(p, f))
            p.on_done(lambda _p, k=pkey: self._proxies.pop(k, None))
        return p

    # -- stealer hooks (called from Engine._dispatch/_done) -------------
    def notify_backlog(self, eng: Engine) -> None:
        """A shard just held another ready task.  Cheap-gated: only looks
        for an idle thief when the backlog first becomes stealable and
        every 256 tasks after, so per-task cost stays O(1)."""
        st = self.stealer
        if st is None or st._scheduled:
            return
        lp = len(eng._pending)
        if lp != st.min_batch and lp & 0xFF:
            return
        now = self.clock.now()
        for s in self.shards:
            if (s is not eng and not s._pending
                    and s.balancer.idle_slots(now) > 0):
                st.poke()
                return

    def notify_idle(self, eng: Engine) -> None:
        """A shard finished a task with no held backlog left — steal if any
        other shard has a stealable queue (O(shards) length checks)."""
        st = self.stealer
        if st is None or st._scheduled:
            return
        mb = st.min_batch
        for s in self.shards:
            if s is not eng and len(s._pending) >= mb:
                st.poke()
                return

    # -- submit-side backpressure (DESIGN.md §9) -----------------------
    def inflight(self) -> int:
        """Tasks submitted but not yet finished, aggregated over shards."""
        return sum(e.inflight() for e in self.shards)

    def ready_backlog(self) -> int:
        """Held ready tasks across all shards (the stealable backlog)."""
        return sum(len(e._pending) for e in self.shards)

    def pool_capacity(self) -> int:
        return sum(e.pool_capacity() for e in self.shards)

    def dispatchable(self) -> int:
        return sum(e.dispatchable() for e in self.shards)

    def saturated(self, slack: float | None = None) -> bool:
        """Aggregate submit-side backpressure: the federation as a whole
        already holds ≥ slack x aggregate pool capacity of dispatchable
        work.  Aggregate, not per-shard: a skewed partition leaves some
        shards starved while others hold backlog, and it is the stealer's
        job to rebalance that — the streaming frontier should keep feeding
        until the *federation* is full, or steals would have nothing to
        migrate."""
        cap = self.pool_capacity()
        if cap <= 0:
            return False
        if slack is None:
            slack = self.shards[0].site_slack
        return self.dispatchable() >= slack * cap

    def add_backpressure_waiter(self, cb) -> None:
        """Single-shot callback fired when a shard completion leaves the
        federation (in aggregate) unsaturated."""
        self._bp_waiters.append(cb)

    def _wake_backpressure(self) -> None:
        if self._bp_waiters and not self.saturated():
            waiters, self._bp_waiters = self._bp_waiters, []
            for cb in waiters:
                cb()

    # ------------------------------------------------------------------
    def run(self):
        if self.stealer is not None:
            self.stealer.poke()          # initial probe (skewed bootstraps)
        self.clock.run()

    @property
    def tasks_completed(self) -> int:
        return sum(e.tasks_completed for e in self.shards)

    @property
    def tasks_failed(self) -> int:
        return sum(e.tasks_failed for e in self.shards)

    def stats(self) -> dict:
        return {
            "submitted": self.tasks_submitted,
            "completed": self.tasks_completed,
            "failed": self.tasks_failed,
            "shards": len(self.shards),
            "per_shard_completed": [e.tasks_completed for e in self.shards],
            "cross_shard_edges": self.cross_shard_edges,
            "makespan": self.clock.now(),
        }

    def metrics(self) -> dict:
        """Bounded federation snapshot — safe at any task count."""
        m = {
            "shards": len(self.shards),
            "submitted": self.tasks_submitted,
            "completed": self.tasks_completed,
            "cross_shard_edges": self.cross_shard_edges,
            "mailboxes": [mb.metrics() for mb in self.mailboxes],
            "in_flight_owned": len(self._owner),
        }
        if self.stealer is not None:
            m["stealer"] = self.stealer.metrics()
        if self.data_layer is not None:
            m["data"] = self.data_layer.metrics()
        if self.health is not None:
            m["health"] = self.health.states()
        return m
