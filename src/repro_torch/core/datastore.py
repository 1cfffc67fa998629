"""Data diffusion: cache-aware data layer for the Falkon service (paper §6).

The paper names data management as the remaining bottleneck once dispatch is
fast, and proposes *data diffusion* as the Falkon follow-on: repeated input
files are served from executor-local caches instead of the shared filesystem,
and the dispatcher steers tasks toward executors that already hold their
inputs.  This module is that data layer:

  * `DataObject`      — descriptor of one input file (name, size, home store)
  * `SharedStore`     — the GPFS-like home filesystem; tracks concurrent
                        readers so staging cost degrades under contention
                        (the Fig-8 aggregate-bandwidth ceiling)
  * `ExecutorCache`   — per-executor local cache with pluggable eviction
                        (LRU / LFU / size-aware) and pin counts: objects in
                        use by a running task are never evicted (deferred)
  * `StagingCostModel`— shared-filesystem vs local-read bandwidth/latency,
                        calibrated like DESIGN.md §6's provider parameters
  * `DataLayer`       — binds the above; owns the per-object *holder index*
                        (object name -> executors caching it) so the
                        cache-aware dispatch lookup is O(task inputs), not
                        O(executors), and bounded `StreamStat`
                        hit/miss/staged-bytes metrics

Scale contract (DESIGN.md §7): per-task cost of the data layer is
O(inputs x probe_limit); all metrics are bounded; the locality-blind path
(`data_layer=None` on the service) is untouched.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING, Iterable, Optional

from repro_torch.core.metrics import StreamStat

if TYPE_CHECKING:
    from repro_torch.core.falkon import Executor
    from repro_torch.core.simclock import Clock


class DataObject:
    """One logical input file: a name, a size, and a home store.

    `store` is provenance only (which store holds the authoritative copy);
    a `DataLayer` prices all staging against the single `SharedStore` it
    was constructed with.
    """

    __slots__ = ("name", "size", "store")

    def __init__(self, name: str, size: float, store: str = "gpfs"):
        if size < 0:
            raise ValueError("DataObject size must be >= 0")
        self.name = name
        self.size = float(size)
        self.store = store

    def __repr__(self):
        return f"DataObject({self.name!r}, {self.size:.3g}B)"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, DataObject) and other.name == self.name


@dataclasses.dataclass
class StagingCostModel:
    """Staging / read cost, calibrated against Fig 8 (see DESIGN.md §7).

    The shared filesystem has an *aggregate* bandwidth ceiling (Fig 8:
    4 GB/s over 8 I/O servers); a single reader cannot exceed
    `shared_reader_bw`, and concurrent readers split the aggregate.  Local
    cache reads avoid both the network and the contention.
    """

    shared_aggregate_bw: float = 4e9     # Fig 8: GPFS, 8 I/O servers
    shared_reader_bw: float = 500e6      # one reader ~ one I/O server
    shared_latency: float = 0.010        # per-read shared-fs round trip
    local_bw: float = 2e9                # executor-local read
    local_latency: float = 0.001

    def shared_read_time(self, size: float, readers: int = 1) -> float:
        bw = min(self.shared_reader_bw,
                 self.shared_aggregate_bw / max(1, readers))
        return self.shared_latency + size / bw

    def local_read_time(self, size: float) -> float:
        return self.local_latency + size / self.local_bw


class SharedStore:
    """The home filesystem (GPFS in the paper's runs).

    Holds the authoritative copy of every `DataObject` and a live
    concurrent-reader count that `DataLayer` uses to price staging under
    contention.  Bookkeeping is O(1) per read.
    """

    def __init__(self, name: str = "gpfs"):
        self.name = name
        self.objects: dict[str, DataObject] = {}
        # real payload bytes (DESIGN.md §10): populated by `put`, read by
        # measured staging; objects declared by size only synthesize a
        # zero-filled payload at read time
        self.payloads: dict[str, bytes] = {}
        self.readers = 0
        self.reads = 0
        self.bytes_read = 0.0

    def add(self, obj: DataObject) -> DataObject:
        self.objects[obj.name] = obj
        return obj

    def put(self, name: str, data: bytes) -> DataObject:
        """Store a real payload (DESIGN.md §10): declares `name` with the
        payload's size and keeps the bytes, so measured staging copies the
        actual content into executor caches instead of synthesizing
        zeros.  Example::

            store = SharedStore()
            archive = store.put("params.tar", b"x" * 4096)
        """
        obj = self.file(name, len(data))
        self.payloads[name] = bytes(data)
        return obj

    def payload(self, obj: DataObject) -> bytes | None:
        """The stored payload for `obj`, or None when it was declared by
        size only (measured staging then synthesizes zeros of that size)."""
        return self.payloads.get(obj.name)

    def file(self, name: str, size: float) -> DataObject:
        """Declare (or look up) a file in this store.  Re-declaring a name
        with a different size is almost certainly a typo and would silently
        skew every byte metric, so it raises."""
        obj = self.objects.get(name)
        if obj is None:
            obj = self.add(DataObject(name, size, self.name))
        elif obj.size != float(size):
            raise ValueError(f"{name!r} already declared with size "
                             f"{obj.size:g}, not {float(size):g}")
        return obj

    def _begin_read(self, size: float) -> None:
        self.readers += 1
        self.reads += 1
        self.bytes_read += size

    def _end_read(self) -> None:
        self.readers -= 1


# ---------------------------------------------------------------------------
# eviction policies
# ---------------------------------------------------------------------------

class EvictionPolicy:
    """Bookkeeping interface for `ExecutorCache` victim selection.

    Implementations must be deterministic (no RNG, no wall clock) so
    cache-aware dispatch replays identically under `SimClock`.
    """

    name = "policy"

    def on_admit(self, obj: DataObject) -> None:
        raise NotImplementedError

    def on_access(self, obj: DataObject) -> None:
        raise NotImplementedError

    def on_evict(self, obj: DataObject) -> None:
        raise NotImplementedError

    def victim(self, cache: "ExecutorCache") -> Optional[str]:
        """Name of the next evictable (present, unpinned) object, else None."""
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Least-recently-used: dict insertion order is recency order."""

    name = "lru"

    def __init__(self):
        self._order: dict[str, None] = {}

    def on_admit(self, obj: DataObject) -> None:
        self._order[obj.name] = None

    def on_access(self, obj: DataObject) -> None:
        # move to most-recent end
        del self._order[obj.name]
        self._order[obj.name] = None

    def on_evict(self, obj: DataObject) -> None:
        self._order.pop(obj.name, None)

    def victim(self, cache: "ExecutorCache") -> Optional[str]:
        for name in self._order:        # oldest first
            if not cache.pinned(name):
                return name
        return None


class LFUPolicy(EvictionPolicy):
    """Least-frequently-used with frequency buckets; ties broken by
    admission order within a bucket (oldest evicted first).  `on_admit` /
    `on_access` are O(1); `victim` scans the *occupied* buckets (at most
    one per cached object, so bounded by cache occupancy, never by how hot
    an object got)."""

    name = "lfu"

    def __init__(self):
        self._freq: dict[str, int] = {}
        self._buckets: dict[int, dict[str, None]] = {}

    def _bump(self, name: str, to: int) -> None:
        self._freq[name] = to
        self._buckets.setdefault(to, {})[name] = None

    def on_admit(self, obj: DataObject) -> None:
        self._bump(obj.name, 1)

    def on_access(self, obj: DataObject) -> None:
        f = self._freq[obj.name]
        bucket = self._buckets[f]
        del bucket[obj.name]
        if not bucket:
            del self._buckets[f]
        self._bump(obj.name, f + 1)

    def on_evict(self, obj: DataObject) -> None:
        f = self._freq.pop(obj.name, None)
        if f is None:
            return
        bucket = self._buckets.get(f)
        if bucket is not None:
            bucket.pop(obj.name, None)
            if not bucket:
                del self._buckets[f]

    def victim(self, cache: "ExecutorCache") -> Optional[str]:
        for f in sorted(self._buckets):
            for name in self._buckets[f]:
                if not cache.pinned(name):
                    return name
        return None


class SizeAwarePolicy(EvictionPolicy):
    """Evict the largest object first (frees the most room per eviction;
    favors keeping many small hot files over one cold archive).  Implemented
    as a max-heap with lazy invalidation — stale entries (already-evicted
    names) are dropped when popped."""

    name = "size"

    def __init__(self):
        import heapq
        self._heapq = heapq
        self._heap: list[tuple[float, int, str]] = []
        self._seq = itertools.count()
        self._live: set[str] = set()

    def on_admit(self, obj: DataObject) -> None:
        self._live.add(obj.name)
        self._heapq.heappush(self._heap, (-obj.size, next(self._seq),
                                          obj.name))

    def on_access(self, obj: DataObject) -> None:
        pass                            # size order is access-independent

    def on_evict(self, obj: DataObject) -> None:
        self._live.discard(obj.name)    # heap entry dropped lazily

    def victim(self, cache: "ExecutorCache") -> Optional[str]:
        heap = self._heap
        skipped = []
        found = None
        while heap:
            entry = self._heapq.heappop(heap)
            name = entry[2]
            if name not in self._live:
                continue                # stale: evicted or superseded
            if cache.pinned(name):
                skipped.append(entry)   # deferred: in use by a running task
                continue
            found = name
            skipped.append(entry)       # re-push; ExecutorCache will call
            break                       # on_evict to invalidate it
        for entry in skipped:
            self._heapq.heappush(heap, entry)
        return found


POLICIES = {"lru": LRUPolicy, "lfu": LFUPolicy, "size": SizeAwarePolicy}


def make_policy(policy) -> EvictionPolicy:
    if isinstance(policy, EvictionPolicy):
        return policy
    if callable(policy):
        return policy()
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {policy!r}; "
                         f"expected one of {sorted(POLICIES)}") from None


# ---------------------------------------------------------------------------
# executor-local cache
# ---------------------------------------------------------------------------

class ExecutorCache:
    """Fixed-capacity (bytes) cache of `DataObject`s on one executor.

    Invariants (tested in tests/test_data_diffusion.py):
      * used bytes never exceed `capacity`;
      * pinned (in-use) objects are never evicted — eviction is deferred to
        the next admission after they are unpinned;
      * an object larger than the whole cache is never admitted (the read
        still happens, the bytes just are not retained).
    """

    def __init__(self, capacity: float, policy="lru"):
        self.capacity = float(capacity)
        self.policy = make_policy(policy)
        self.objects: dict[str, DataObject] = {}
        # real cached bytes (DESIGN.md §10): filled by measured staging on
        # the real execution path, keyed like `objects`; empty on the
        # simulated path.  Bounded by `capacity` because admission is.
        self.data: dict[str, bytes] = {}
        self.used = 0.0
        self.evictions = 0
        self._pins: dict[str, int] = {}
        self._pinned_bytes = 0.0

    def __contains__(self, name: str) -> bool:
        return name in self.objects

    def contains(self, name: str) -> bool:
        return name in self.objects

    def touch(self, name: str) -> None:
        self.policy.on_access(self.objects[name])

    def pinned(self, name: str) -> bool:
        return name in self._pins

    def pin(self, name: str) -> None:
        obj = self.objects.get(name)
        if obj is None:
            return
        n = self._pins.get(name, 0)
        if n == 0:
            self._pinned_bytes += obj.size
        self._pins[name] = n + 1

    def unpin(self, name: str) -> None:
        n = self._pins.get(name)
        if n is None:
            return
        if n <= 1:
            del self._pins[name]
            obj = self.objects.get(name)
            if obj is not None:
                self._pinned_bytes -= obj.size
        else:
            self._pins[name] = n - 1

    def admit(self, obj: DataObject) -> tuple[bool, list[DataObject]]:
        """Try to cache `obj`; returns (admitted, evicted objects).

        Evicts per policy until there is room; if pinned objects leave too
        little evictable space, the object is simply not retained (cache
        bypass) — capacity is never exceeded.
        """
        if obj.name in self.objects:
            self.touch(obj.name)
            return True, []
        # feasibility first: pinned bytes are not evictable, so an object
        # that cannot fit beside them is bypassed *without* gutting the
        # cache of evictable-but-useful replicas.  A zero-capacity cache
        # retains nothing — including zero-size objects — so the GPFS-only
        # baseline stays exactly locality-blind.
        if self.capacity <= 0 or obj.size > self.capacity - self._pinned_bytes:
            return False, []
        evicted: list[DataObject] = []
        while self.used + obj.size > self.capacity:
            name = self.policy.victim(self)
            if name is None:            # defensive; feasibility checked above
                return False, evicted
            evicted.append(self._evict(name))
        self.objects[obj.name] = obj
        self.used += obj.size
        self.policy.on_admit(obj)
        return True, evicted

    def _evict(self, name: str) -> DataObject:
        obj = self.objects.pop(name)
        self.data.pop(name, None)
        self.used -= obj.size
        self.evictions += 1
        self.policy.on_evict(obj)
        return obj


# ---------------------------------------------------------------------------
# the data layer
# ---------------------------------------------------------------------------

class ShardDirectory:
    """Cross-shard holder directory (DESIGN.md §8): object name -> set of
    shard ids with at least one executor caching it.

    This is the *small* half of the sharded holder index: per-executor
    holder maps stay inside each shard's `DataLayer` (they are the hot,
    per-dispatch structure), while the directory answers the federation's
    coarse question — "does shard S hold object X at all?" — in O(1) for
    steal-time restage pricing.  Entries are maintained at shard
    granularity (first holder in a shard adds it, last holder drops it),
    so the directory is bounded by live objects x shards, independent of
    executor count and task count.
    """

    def __init__(self, on_change=None):
        self._map: dict[str, set[int]] = {}
        # cross-process propagation hook (DESIGN.md §14): in a
        # process-per-shard federation each shard's directory is local, so
        # membership changes must travel as messages instead of
        # shared-memory mutation — `on_change("add"|"drop", name, shard)`
        # fires on every first-holder add / last-holder drop and the shard
        # host batches the deltas to the parent's replica.  None (the
        # in-process default) keeps add/drop allocation-free.
        self.on_change = on_change

    def add(self, name: str, shard: int | None) -> None:
        shards = self._map.get(name)
        if shards is None:
            self._map[name] = shards = set()
        if shard not in shards:
            shards.add(shard)
            if self.on_change is not None:
                self.on_change("add", name, shard)

    def drop(self, name: str, shard: int | None) -> None:
        shards = self._map.get(name)
        if shards is not None and shard in shards:
            shards.discard(shard)
            if not shards:
                del self._map[name]
            if self.on_change is not None:
                self.on_change("drop", name, shard)

    def shards_holding(self, name: str) -> frozenset:
        return frozenset(self._map.get(name, ()))

    def holds(self, name: str, shard: int | None) -> bool:
        shards = self._map.get(name)
        return shards is not None and shard in shards

    def __len__(self):
        return len(self._map)


class DataLayer:
    """Cache-aware data management bound to one Falkon service.

    Owns the shared store, the staging cost model, one `ExecutorCache` per
    registered executor, and the *holder index* `object name -> {executor id
    -> executor}` used by cache-aware dispatch.  The index lets the service
    answer "is any idle executor already holding this task's inputs?" in
    O(inputs x probe_limit): for each input it probes at most `probe_limit`
    holders instead of intersecting with the full idle pool.
    """

    def __init__(self, shared: SharedStore | None = None,
                 cost: StagingCostModel | None = None,
                 cache_capacity: float = 1e9, policy="lru",
                 probe_limit: int = 8, affinity_frac: float = 0.5,
                 max_local_queue: int = 128, park_patience: float = 96.0):
        self.shared = shared or SharedStore()
        # holder-index sharding (DESIGN.md §8): when this layer is one
        # shard of a `ShardedDataLayer`, `directory` is the federation's
        # cross-shard directory and `shard_id` this layer's shard; the
        # directory tracks only *which shards* hold an object (first
        # holder appears / last holder drops), so it stays small while the
        # per-executor holder maps stay shard-local
        self.shard_id: int | None = None
        self.directory = None
        self.cost = cost or StagingCostModel()
        self.cache_capacity = float(cache_capacity)
        self.policy = policy
        self.probe_limit = probe_limit
        # affinity routing (DESIGN.md §7): a task waits behind a *busy*
        # holder only when that holder covers at least `affinity_frac` of
        # its input bytes, the holder's local queue is shorter than
        # `max_local_queue`, and the work already parked there is within
        # `park_patience x` the estimated staging cost of going cold.
        # Otherwise it spills to an idle holder/executor (staging a
        # replica) or waits in the global queue for capacity.  The
        # patience term keeps compute-heavy tasks (staging cheap relative
        # to their runtime) from serializing a wide fan-out behind one
        # holder while the rest of the pool idles; data-heavy tasks still
        # queue deep and keep their bytes local.
        self.affinity_frac = affinity_frac
        self.max_local_queue = max_local_queue
        self.park_patience = park_patience
        # observability (DESIGN.md §12): set to a `Tracer` to emit one
        # `stage_bytes` event per dispatch that staged cold bytes
        self.tracer = None
        self._holders: dict[str, dict[int, "Executor"]] = {}
        # bounded metrics (DESIGN.md §4): counters + StreamStat reservoirs
        self.hits = 0
        self.misses = 0
        self.bytes_local = 0.0
        self.bytes_staged = 0.0
        self.staged_stat = StreamStat(cap=512)   # staged bytes per dispatch
        self.hit_stat = StreamStat(cap=512)      # hit fraction per dispatch
        # real path only (DESIGN.md §10): measured staging seconds per task
        self.measured_io_stat = StreamStat(cap=512)

    # -- executor lifecycle --------------------------------------------------
    def register_executor(self, e: "Executor") -> None:
        e.cache = ExecutorCache(self.cache_capacity, self.policy)

    def deregister_executor(self, e: "Executor") -> None:
        cache = e.cache
        if cache is None:
            return
        for name in cache.objects:
            self._drop_holder(name, e)
        e.cache = None

    # -- holder-index queries -------------------------------------------------
    def holds(self, name: str) -> bool:
        """True when at least one registered executor caches `name` —
        O(1); used by the balancer's affinity term and by cross-shard
        restage accounting."""
        return name in self._holders

    # -- cache-aware placement ----------------------------------------------
    def pick_home(self, task, now: float):
        """Routing decision for one task, via the holder index.

        Returns ``(executor, run_now)``: with ``run_now`` True the executor
        is idle and should run the task immediately; with False it is a busy
        holder worth waiting behind (append to its local queue).  Returns
        ``(None, False)`` when no holder is attractive — the caller falls
        back to locality-blind first-idle dispatch, or leaves the task at
        the head of the global queue where any executor that frees (or
        arrives via DRP growth) can take it.

        Parking is bounded by the wait-vs-stage test unconditionally — not
        just when an idle executor is visible right now — because refusing
        commits nothing: the task simply stays in the global queue while
        capacity frees or grows.

        Cost is O(inputs x probe_limit): for each input at most
        `probe_limit` holders are probed, and each probe's byte-coverage
        scan is O(inputs) (input tuples are small).
        """
        inputs = task.inputs
        total = 0.0
        for o in inputs:
            total += o.size
        best_idle = best_busy = None
        idle_bytes = busy_bytes = 0.0
        busy_qlen = 0
        seen: set = set()
        for obj in inputs:
            holders = self._holders.get(obj.name)
            if not holders:
                continue
            # probe order is holder-registration order and bounded by
            # probe_limit per input — holders past the bound are invisible
            # to this decision by design (the bound is what keeps routing
            # O(inputs)); `seen` skips re-scoring an executor that holds
            # several of the task's inputs
            probes = 0
            for e in holders.values():
                if probes >= self.probe_limit:
                    break
                probes += 1
                if e.id in seen:
                    continue
                seen.add(e.id)
                if now < e.suspended_until or e.cache is None:
                    continue
                covered = sum(o.size for o in inputs
                              if o.name in e.cache.objects)
                if e.busy:
                    qlen = len(e.local_q)
                    if qlen < self.max_local_queue and (
                            covered > busy_bytes or
                            (covered == busy_bytes and best_busy is not None
                             and qlen < busy_qlen)):
                        best_busy, busy_bytes, busy_qlen = e, covered, qlen
                elif covered > idle_bytes:
                    best_idle, idle_bytes = e, covered
        if best_idle is not None and idle_bytes >= busy_bytes:
            return best_idle, True
        if best_busy is not None and busy_bytes >= self.affinity_frac * total:
            # wait-vs-stage: parking serializes behind the holder, so it is
            # only worth it while the wait stays comparable to re-staging
            # the inputs cold elsewhere
            stage_est = self.cost.shared_read_time(total,
                                                   self.shared.readers + 1)
            if best_busy.local_work <= self.park_patience * stage_est:
                return best_busy, False
        if best_idle is not None:
            return best_idle, True
        return None, False

    # -- staging -------------------------------------------------------------
    def stage_inputs(self, e: "Executor", task, clock: "Clock") -> float:
        """Price the task's input reads on executor `e`, update its cache and
        the holder index, and pin inputs for the run; returns the total I/O
        time to add to the task's service time.

        Contention approximation: a task's own reads are serial, so read k
        is priced against *external* readers only (its own earlier reads
        have finished by the time it starts) and each read's release event
        fires at its serialized end, not at the dispatch instant.  External
        windows still all open at dispatch time — exact interleaving would
        need one extra event per read start, which the miss path does not
        pay.
        """
        cache = e.cache
        io = 0.0
        hits = misses = 0
        staged = 0.0
        own_open = 0
        stage_end = 0.0                 # cumulative serialized staging time
        for obj in task.inputs:
            if cache is not None and obj.name in cache.objects:
                cache.touch(obj.name)
                hits += 1
                self.bytes_local += obj.size
                io += self.cost.local_read_time(obj.size)
            else:
                misses += 1
                staged += obj.size
                shared = self.shared
                shared._begin_read(obj.size)
                own_open += 1
                t = self.cost.shared_read_time(
                    obj.size, shared.readers - own_open + 1)
                stage_end += t
                clock.schedule(stage_end, shared._end_read)
                io += t
                if cache is not None:
                    admitted, evicted = cache.admit(obj)
                    if admitted:
                        holders = self._holders.get(obj.name)
                        if holders is None:
                            self._holders[obj.name] = holders = {}
                            if self.directory is not None:
                                self.directory.add(obj.name, self.shard_id)
                        holders[e.id] = e
                    for ev in evicted:
                        self._drop_holder(ev.name, e)
            if cache is not None:
                cache.pin(obj.name)
        self.hits += hits
        self.misses += misses
        self.bytes_staged += staged
        now = clock.now()
        self.staged_stat.observe(now, staged)
        n = hits + misses
        if n:
            self.hit_stat.observe(now, hits / n)
        if staged and self.tracer is not None:
            self.tracer.event("stage_bytes", now, staged)
        return io

    # -- measured staging (real execution path, DESIGN.md §10) ---------------
    def plan_staging(self, e: "Executor", task) -> "_StagePlan":
        """Clock-thread half of *measured* staging: identical cache, holder
        index, pin, and byte accounting to `stage_inputs`, but instead of
        pricing the reads it returns a `_StagePlan` — a callable the worker
        pool runs inside the task's service time to perform the real byte
        copies (shared-store payload -> executor cache for misses, cache ->
        local read for hits).  `end_staging` closes the books when the
        measured completion comes back.

        The worker touches only the plan's copy list and `cache.data` (its
        own pinned keys — never evicted mid-run, so no clock-thread
        conflict); all index/metric state stays on the clock thread.
        """
        cache = e.cache
        copies: list = []
        hits = misses = 0
        staged = 0.0
        open_reads = 0
        for obj in task.inputs:
            if cache is not None and obj.name in cache.objects:
                cache.touch(obj.name)
                hits += 1
                self.bytes_local += obj.size
                copies.append((obj, cache, False))
            else:
                misses += 1
                staged += obj.size
                self.shared._begin_read(obj.size)
                open_reads += 1
                admitted = False
                if cache is not None:
                    admitted, evicted = cache.admit(obj)
                    if admitted:
                        holders = self._holders.get(obj.name)
                        if holders is None:
                            self._holders[obj.name] = holders = {}
                            if self.directory is not None:
                                self.directory.add(obj.name, self.shard_id)
                        holders[e.id] = e
                    for ev in evicted:
                        self._drop_holder(ev.name, e)
                copies.append((obj, cache if admitted else None, True))
            if cache is not None:
                cache.pin(obj.name)
        self.hits += hits
        self.misses += misses
        self.bytes_staged += staged
        return _StagePlan(self.shared, copies, open_reads, hits, misses,
                          staged)

    def end_staging(self, plan: "_StagePlan", io_s: float,
                    now: float) -> None:
        """Close a `plan_staging` plan on the clock thread: release the
        shared-store reader slots the plan's misses held for the duration
        of the real copies, and record the plan's byte/hit stats plus the
        *measured* staging seconds."""
        for _ in range(plan.open_reads):
            self.shared._end_read()
        self.staged_stat.observe(now, plan.staged)
        n = plan.hits + plan.misses
        if n:
            self.hit_stat.observe(now, plan.hits / n)
        self.measured_io_stat.observe(now, io_s)
        if plan.staged and self.tracer is not None:
            self.tracer.event("stage_bytes", now, plan.staged)

    def release_inputs(self, e: "Executor", task) -> None:
        cache = e.cache
        if cache is None:
            return
        for obj in task.inputs:
            cache.unpin(obj.name)

    def _drop_holder(self, name: str, e: "Executor") -> None:
        holders = self._holders.get(name)
        if holders is not None:
            holders.pop(e.id, None)
            if not holders:
                del self._holders[name]
                if self.directory is not None:
                    self.directory.drop(name, self.shard_id)

    # -- metrics -------------------------------------------------------------
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def metrics(self) -> dict:
        """Bounded snapshot — safe at any task count."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate(),
            "bytes_local": self.bytes_local,
            "bytes_staged": self.bytes_staged,
            "staged_per_task": self.staged_stat.summary(),
            "hit_fraction": self.hit_stat.summary(),
            "shared_reads": self.shared.reads,
            "shared_bytes": self.shared.bytes_read,
            "indexed_objects": len(self._holders),
            "measured_io_s": self.measured_io_stat.summary(),
        }


class _StagePlan:
    """One task's worth of real staging copies (DESIGN.md §10).

    Built by `DataLayer.plan_staging` on the clock thread; called by a
    worker inside the task's measured service time.  A miss materializes
    the shared store's payload (stored bytes, or synthesized zeros for
    size-only objects) and retains it in `cache.data` when the object was
    admitted; a hit copies out of the executor's cache (the local read).
    """

    __slots__ = ("shared", "copies", "open_reads", "hits", "misses",
                 "staged")

    def __init__(self, shared: SharedStore, copies: list, open_reads: int,
                 hits: int, misses: int, staged: float):
        self.shared = shared
        self.copies = copies
        self.open_reads = open_reads
        self.hits = hits
        self.misses = misses
        self.staged = staged

    def __call__(self) -> None:
        for obj, cache, is_miss in self.copies:
            if is_miss:
                src = self.shared.payload(obj)
                # the shared-store read: copy the payload (or synthesize a
                # zero-filled buffer of the declared size — an equivalent
                # allocation+fill)
                data = bytes(bytearray(src)) if src is not None \
                    else bytes(int(obj.size))
                if cache is not None:       # admitted on the clock thread
                    cache.data[obj.name] = data
            else:
                src = cache.data.get(obj.name)
                if src is None:
                    # cache-resident from a sim run or seeded by size only:
                    # materialize once so later local reads copy real bytes
                    src = cache.data[obj.name] = bytes(int(obj.size))
                bytearray(src)              # the local read: one real copy


def inputs_of(spec, *args) -> tuple:
    """Normalize an input declaration: a `DataObject`, an iterable of them,
    or a callable mapping call args -> either."""
    if spec is None:
        return ()
    if callable(spec) and not isinstance(spec, DataObject):
        spec = spec(*args)
        if spec is None:
            return ()
    if isinstance(spec, DataObject):
        return (spec,)
    return tuple(spec)
