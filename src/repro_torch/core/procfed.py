"""Process-per-shard federation: one OS process per dispatcher
(DESIGN.md §14).

The in-process federation (§8) multiplies *dispatchers* — N engines, N
Falkon services — but they all share one Python interpreter, so on the
real execution path (`RealClock` + `ThreadExecutorPool`) every shard's
clock thread and worker threads contend for one GIL.  This module runs
each shard as its own process — a full `Engine` + `RealClock` + worker
pool built from a picklable `ShardSpec` recipe — with the existing
`Mailbox` crossing the boundary through a `ProcessTransport`: the
parent keeps the driver-side `DataFuture`s, every message is a small
pickle-safe tuple, and a reader thread per boundary drains receive
bursts onto the consumer's clock thread in one `post_many` wakeup.

Topology: the parent is the hub.  It routes each submission by the
partitioner, encodes pending-future arguments as `Ref(fid)` markers,
and registers a *forward* for every Ref it ships — when the producing
fid resolves, the parent fans a ``("resolve", ...)`` envelope out to
every shard that ever received a Ref for it.  Per-pipe FIFO ordering
then gives the fence invariant: a resolve envelope always arrives
*after* every Ref for its fid, so a shard can drop its local handle the
moment the envelope lands.

Work stealing is parent-coordinated (the parent is the only place the
global load vector exists): an idle shard triggers a ``("steal", ...)``
request to a victim chosen by the same load/directory policies as the
in-process `WorkStealer`; the victim re-encodes up to half its held
ready queue — all arguments already resolved, so the envelopes carry
raw values — and the parent re-submits the batch to the thief.  The
``"directory"`` policy prices victims against a parent-side replica of
each shard's `ShardDirectory` (kept fresh by ``("dir", ...)`` deltas),
preferring the victim whose sampled in-flight inputs the thief would
re-stage least.

Failure contract: a shard process that dies mid-run surfaces as EOF on
its boundary; the parent fails that shard's in-flight futures with
``TaskFailure(kind="host")``, emits a ``shard_death`` tracer event (so
a `HealthMonitor` subscribed to the tracer sees it), routes new work to
the surviving shards, and `run()` terminates instead of hanging.
"""
from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

from repro_torch.core.datastore import (DataLayer, ShardDirectory, SharedStore,
                                  StagingCostModel, inputs_of)
from repro_torch.core.engine import Engine
from repro_torch.core.falkon import DRPConfig, FalkonConfig, FalkonService
from repro_torch.core.faults import RetryPolicy, TaskFailure
from repro_torch.core.federation import Mailbox, MailboxTransport, hash_partitioner
from repro_torch.core.futures import DataFuture
from repro_torch.core.metrics import StreamStat
from repro_torch.core.observability import RunReport, Tracer, build_report
from repro_torch.core.providers import FalkonProvider
from repro_torch.core.realpool import ThreadExecutorPool
from repro_torch.core.simclock import RealClock

__all__ = ["Ref", "ShardSpec", "ProcessTransport", "SocketTransport",
           "ShardHost", "ProcessFederation"]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

class Ref:
    """Pickle-safe marker for a not-yet-resolved argument crossing the
    process boundary: the parent substitutes ``Ref(fid)`` for a pending
    `DataFuture` and later ships a ``("resolve", ...)`` envelope carrying
    the fid's value (or error).  Shards decode a Ref into a local future
    registered with their `Mailbox` under the same fid."""

    __slots__ = ("fid",)

    def __init__(self, fid: int):
        self.fid = fid

    def __reduce__(self):
        return (Ref, (self.fid,))

    def __eq__(self, other):
        return type(other) is Ref and other.fid == self.fid

    def __hash__(self):
        return hash(("Ref", self.fid))

    def __repr__(self):
        return f"Ref({self.fid})"


@dataclass
class ShardSpec:
    """Picklable build recipe for one shard process.

    The child cannot receive live objects (engines, clocks, pools do not
    pickle), so the parent ships this declarative spec and the child's
    `ShardHost` builds the stack from it: `RealClock`, `Engine`
    (summary provenance), autoscaling `ThreadExecutorPool`, and one
    `FalkonService` site.  ``cache_capacity=None`` skips the data layer;
    otherwise every shard pre-declares ``shared_files`` (name, size)
    pairs in its own `SharedStore` replica and streams holder-map
    deltas back to the parent for directory-guided stealing.
    """

    executors: int = 4
    serialize_dispatch: bool = False
    dispatch_overhead: float = 1.0 / 487.0
    alloc_latency: float = 1e-3
    cache_capacity: float | None = None
    policy: str = "lru"
    shared_files: tuple = ()
    trace_sample: int = 0
    engine_kwargs: dict = field(default_factory=dict)


# -- module-level task bodies (spawn-context children can only unpickle
#    importable callables, so tests and benchmarks use these) ---------------

def body_sleep(seconds: float = 0.001) -> float:
    """Latency-bound task body: sleep and return the duration."""
    time.sleep(seconds)
    return seconds


def body_value(v):
    """Identity task body."""
    return v


def body_scale(v, k: float = 2):
    """Multiply-by-constant task body."""
    return v * k


def body_sum(*vals):
    """Sum task body (stage-3 joins in the MolDyn-shaped tests)."""
    total = 0
    for v in vals:
        total += v
    return total


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class ProcessTransport(MailboxTransport):
    """`MailboxTransport` over a duplex connection to another process.

    ``conn`` is anything with the `multiprocessing.Connection` subset
    ``send/recv/poll/close`` — a real pipe `Connection`, or `_SockConn`
    for the socket-framed variant.  Sends are locked (producers include
    worker callbacks and the driver thread) and count under the lock;
    receives run on a dedicated daemon reader thread that batches a
    burst of available messages and hands the whole burst to the
    consumer's clock thread in one `Clock.post_many` wakeup — one lock
    acquisition and one condition-variable notify per burst, not per
    message.  ``("resolve", ...)`` messages route to the bound
    `Mailbox._deliver`; everything else goes to the ``dispatch``
    callback given to `start`.
    """

    BURST = 256

    def __init__(self, conn):
        self._conn = conn
        self._wlock = threading.Lock()
        self._clock = None
        self._deliver: Callable | None = None
        self._reader: threading.Thread | None = None
        self.closed = False
        self.sends = 0
        self.recvs = 0
        self.drains = 0

    def bind(self, clock, deliver: Callable) -> None:
        self._clock = clock
        self._deliver = deliver

    def send(self, msg) -> None:
        # pickling errors propagate (the connection stays clean — both
        # pipe Connections and _SockConn serialize fully before writing),
        # so callers can retry with a sanitized payload; a *broken*
        # connection just marks the transport closed and the reader's
        # EOF handles the rest
        with self._wlock:
            if self.closed:
                return
            try:
                self._conn.send(msg)
                self.sends += 1
            except (OSError, ValueError):
                self.closed = True

    def start(self, dispatch: Callable, on_eof: Callable) -> None:
        """Launch the boundary reader thread (after `bind`)."""
        self._reader = threading.Thread(
            target=self._read_loop, args=(dispatch, on_eof),
            daemon=True, name="procfed-reader")
        self._reader.start()

    def _read_loop(self, dispatch: Callable, on_eof: Callable) -> None:
        conn = self._conn
        clock = self._clock
        deliver = self._deliver
        while True:
            try:
                burst = [conn.recv()]
            except (EOFError, OSError):
                clock.post(on_eof)
                return
            try:
                while len(burst) < self.BURST and conn.poll(0):
                    burst.append(conn.recv())
            except (EOFError, OSError):
                pass                    # deliver what we have; EOF next recv
            self.recvs += len(burst)
            self.drains += 1
            fns = []
            for m in burst:
                if m[0] == "resolve" and deliver is not None:
                    fns.append(partial(deliver, m[1]))
                else:
                    fns.append(partial(dispatch, m))
            clock.post_many(fns)

    def close(self) -> None:
        with self._wlock:
            self.closed = True
            try:
                self._conn.close()
            except OSError:
                pass

    def metrics(self) -> dict:
        return {"sends": self.sends, "recvs": self.recvs,
                "drains": self.drains, "closed": self.closed}


class _SockConn:
    """Length-prefixed pickle framing over a stream socket, exposing the
    `Connection` subset `ProcessTransport` needs (send/recv/poll/close).
    Frames are ``!I`` byte-length headers followed by the pickle; a
    frame is fully serialized before any byte is written, so a pickling
    error never corrupts the stream."""

    _HDR = struct.Struct("!I")

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def send(self, obj) -> None:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._sock.sendall(self._HDR.pack(len(data)) + data)

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("socket closed")
            buf.extend(chunk)
        return bytes(buf)

    def recv(self):
        n, = self._HDR.unpack(self._read_exact(self._HDR.size))
        return pickle.loads(self._read_exact(n))

    def poll(self, timeout: float = 0.0) -> bool:
        import select
        r, _, _ = select.select([self._sock], [], [], timeout)
        return bool(r)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class SocketTransport(ProcessTransport):
    """`ProcessTransport` over a TCP socket instead of a pipe — the
    framing `_SockConn` provides, same reader/burst/post_many delivery.
    Lets shard processes live on other hosts in principle; the federation
    uses loopback (``transport="socket"``) and identifies each inbound
    connection by its first ``("ready", shard_id)`` frame."""

    def __init__(self, sock: socket.socket):
        super().__init__(_SockConn(sock))


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------

def _shard_main(shard_id: int, spec: ShardSpec, endpoint) -> None:
    """Child-process entry point (the spawn target): build one shard from
    its spec and serve until the parent says shutdown (or disappears)."""
    ShardHost(shard_id, spec, endpoint).serve()


class ShardHost:
    """One shard process: a full engine stack plus the boundary protocol.

    Owns the child's `RealClock`, `Engine`, `ThreadExecutorPool`,
    `FalkonService` site, optional `DataLayer`, and the `Mailbox` whose
    transport is the pipe/socket back to the parent.  Duck-types the
    federation surface the engine's O(1) hooks expect
    (`notify_backlog` / `notify_idle` / `_bp_waiters` /
    `_wake_backpressure`), reporting load to the parent instead of
    poking a local stealer.  The host takes one permanent clock hold (the
    service token) so `Clock.run` idles between messages instead of
    exiting; ``("shutdown",)`` releases it.
    """

    def __init__(self, shard_id: int, spec: ShardSpec, endpoint):
        self.shard_id = shard_id
        self.spec = spec
        if endpoint[0] == "pipe":
            conn = endpoint[1]
        elif endpoint[0] == "tcp":
            sock = socket.create_connection((endpoint[1], endpoint[2]))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _SockConn(sock)
        else:
            raise ValueError(f"unknown endpoint {endpoint[0]!r}")
        self.clock = RealClock()
        self.transport = ProcessTransport(conn)
        self.mailbox = Mailbox(self.clock, shard_id,
                               transport=self.transport)
        # the mailbox bound the transport to its own _deliver; re-bind to
        # the host hook so resolve envelopes also retire `_refs` entries
        # (the envelope is the fence — no more Refs for that fid can come)
        self.transport.bind(self.clock, self._on_resolve)
        self.tracer = (Tracer(sample_every=spec.trace_sample)
                       if spec.trace_sample > 0 else None)
        self.shared: SharedStore | None = None
        self.dl: DataLayer | None = None
        if spec.cache_capacity is not None:
            self.shared = SharedStore()
            for name, size in spec.shared_files:
                self.shared.file(name, size)
            self.dl = DataLayer(self.shared, StagingCostModel(),
                                cache_capacity=spec.cache_capacity,
                                policy=spec.policy)
            self.dl.shard_id = shard_id
            self.dl.directory = ShardDirectory(on_change=self._dir_change)
        kw = {"provenance": "summary", "tracer": self.tracer}
        kw.update(spec.engine_kwargs)
        self.eng = Engine(self.clock, **kw)
        self.pool = ThreadExecutorPool(self.clock, name=f"shard{shard_id}",
                                       tracer=self.tracer)
        self.svc = FalkonService(
            self.clock,
            FalkonConfig(dispatch_overhead=spec.dispatch_overhead,
                         serialize_dispatch=spec.serialize_dispatch,
                         drp=DRPConfig(max_executors=spec.executors,
                                       alloc_latency=spec.alloc_latency,
                                       alloc_chunk=spec.executors)),
            name=f"falkon{shard_id}", data_layer=self.dl, pool=self.pool,
            tracer=self.tracer)
        self.eng.add_site(f"falkon{shard_id}", FalkonProvider(self.svc),
                          capacity=spec.executors, data_layer=self.dl)
        self.eng.shard_id = shard_id
        self.eng._federation = self
        self.eng._hold_excess = True       # keep excess ready work stealable
        # boundary bookkeeping
        self._refs: dict[int, DataFuture] = {}    # fid -> local future
        self._owned: set[int] = set()             # fids this shard reports
        self._fid_by_out: dict[int, int] = {}     # local out.id -> fid
        self._done_batch: list = []
        self._done_flush = False
        self._dir_batch: list = []
        self._dir_flush = False
        self._load_flush = False
        self._stopping = False
        self._bp_waiters: list = []               # engine reads this directly

    # -- engine federation hooks (all O(1)) -----------------------------
    def notify_backlog(self, eng) -> None:
        self._queue_load()

    def notify_idle(self, eng) -> None:
        self._queue_load()

    def _wake_backpressure(self) -> None:
        if self._bp_waiters:
            waiters, self._bp_waiters = self._bp_waiters, []
            for cb in waiters:
                cb()

    def _queue_load(self) -> None:
        if not self._load_flush:
            self._load_flush = True
            self.clock.schedule(0.0, self._send_load)

    def _send_load(self) -> None:
        self._load_flush = False
        self.transport.send(
            ("load", len(self.eng._pending),
             self.eng.balancer.idle_slots(self.clock.now())))

    # -- serve loop -----------------------------------------------------
    def serve(self) -> None:
        self.clock.hold()                 # service token: idle != finished
        self.transport.start(self._on_msg, self._on_eof)
        self.transport.send(("ready", self.shard_id))
        self.clock.run()
        self.svc.shutdown()
        try:
            self.transport.send(("stats", self.stats_snapshot()))
        except Exception:
            pass                          # parent already gone: exit quietly
        self.transport.close()

    def _on_eof(self) -> None:
        # parent died (or closed the boundary): release the service token
        # so the run loop drains in-flight work and exits
        if not self._stopping:
            self._stopping = True
            self.clock.release()

    # -- message handling (clock thread) --------------------------------
    def _on_msg(self, msg) -> None:
        tag = msg[0]
        if tag == "submit":
            for env in msg[1]:
                self._submit_env(env)
        elif tag == "steal":
            self._steal(msg[1], msg[2])
        elif tag == "drop":
            for fid in msg[1]:
                self._refs.pop(fid, None)
        elif tag == "shutdown":
            if not self._stopping:
                self._stopping = True
                self.clock.release()

    def _on_resolve(self, envs: list) -> None:
        for env in envs:
            self._refs.pop(env[0], None)  # the fence: no more Refs for fid
        self.mailbox._deliver(envs)

    def _submit_env(self, env) -> None:
        fid, name, fn, args, duration, app, key, inputs = env
        dargs = []
        for a in args:
            if type(a) is Ref:
                f = self._refs.get(a.fid)
                if f is None:
                    f = DataFuture(name=f"ref{a.fid}")
                    self._refs[a.fid] = f
                    self.mailbox.register_proxy(a.fid, f)
                dargs.append(f)
            else:
                dargs.append(a)
        objs = None
        if inputs and self.shared is not None:
            objs = tuple(self.shared.file(n, s) for n, s in inputs)
        out = self.eng.submit(name, fn, dargs, duration=duration, app=app,
                              key=key, inputs=objs)
        self._refs[fid] = out
        self._owned.add(fid)
        self._fid_by_out[out.id] = fid
        out.on_done(partial(self._task_done, fid))

    def _task_done(self, fid: int, fut: DataFuture) -> None:
        self._fid_by_out.pop(fut.id, None)
        if fid not in self._owned:
            return                        # stolen away: the thief reports it
        self._owned.discard(fid)
        if fut.failed:
            self._done_batch.append((fid, False, fut._error))
        else:
            self._done_batch.append((fid, True, fut.get()))
        if not self._done_flush:
            self._done_flush = True
            self.clock.schedule(0.0, self._flush_done)

    def _flush_done(self) -> None:
        self._done_flush = False
        batch, self._done_batch = self._done_batch, []
        if not batch:
            return
        backlog = len(self.eng._pending)
        idle = self.eng.balancer.idle_slots(self.clock.now())
        try:
            self.transport.send(("done", batch, backlog, idle))
        except Exception:
            # some payload refused to pickle: degrade just that task to a
            # TaskFailure instead of killing the shard
            safe = []
            for fid, ok, payload in batch:
                try:
                    pickle.dumps(payload)
                    safe.append((fid, ok, payload))
                except Exception:
                    safe.append((fid, False, TaskFailure(
                        f"unpicklable task payload: {payload!r:.120}")))
            self.transport.send(("done", safe, backlog, idle))

    def _steal(self, req_id: int, n: int) -> None:
        batch = self.eng._pending.steal(n) if n > 0 else []
        envs = []
        for task, _excl in batch:
            fid = self._fid_by_out.pop(task.output.id, None)
            if fid is None:               # not parent-tracked: run it here
                self.eng._dispatch(task)
                continue
            self._owned.discard(fid)
            # local dependents keep resolving when the thief's result is
            # forwarded back through the mailbox
            self.mailbox.register_proxy(fid, task.output)
            values = [a.get() if isinstance(a, DataFuture) else a
                      for a in task.args]
            envs.append((fid, task.name, task.fn, values, task.duration,
                         task.app, task.key,
                         tuple((o.name, o.size)
                               for o in (task.inputs or ()))))
        self.transport.send(("stolen", req_id, envs,
                             len(self.eng._pending)))

    def _dir_change(self, op: str, name: str, shard: int) -> None:
        self._dir_batch.append((op, name))
        if not self._dir_flush:
            self._dir_flush = True
            self.clock.schedule(0.0, self._flush_dir)

    def _flush_dir(self) -> None:
        self._dir_flush = False
        batch, self._dir_batch = self._dir_batch, []
        if batch:
            self.transport.send(("dir", batch))

    def stats_snapshot(self) -> dict:
        """Picklable end-of-run telemetry the parent merges (§14)."""
        return {
            "shard": self.shard_id,
            "tasks_completed": self.eng.tasks_completed,
            "tasks_failed": self.eng.tasks_failed,
            "pool": self.pool.stats_snapshot(),
            "mailbox": self.mailbox.metrics(),
            "transport": self.transport.metrics(),
            "tracer": self.tracer.snapshot() if self.tracer else None,
            "data": self.dl.metrics() if self.dl else None,
        }


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class ProcessFederation:
    """Drive one workflow over N shard *processes* (DESIGN.md §14).

    Duck-types the `Engine` surface the DSL uses (`submit`, `run`,
    `clock`, aggregate counters), like `FederatedEngine`, but each shard
    is an OS process built from a `ShardSpec`, so N dispatchers means N
    GILs on the real execution path.  The parent owns every driver-side
    `DataFuture` and one clock hold per in-flight task — `run()` returns
    exactly when all submitted work has resolved (completed, failed, or
    failed-over after a shard death).

    Example::

        fed = ProcessFederation(4, ShardSpec(executors=2))
        futs = [fed.submit("t", body_sleep, [0.001]) for _ in range(1000)]
        fed.run()
        fed.shutdown()                    # collects per-shard telemetry

    ``transport="pipe"`` (default) uses multiprocessing pipes;
    ``"socket"`` uses length-prefixed frames over loopback TCP.  Steal
    coordination is parent-side with the same ``victim_policy`` choices
    as `WorkStealer` (``"load"`` / ``"directory"``).
    """

    def __init__(self, n_shards: int, spec: ShardSpec | None = None,
                 clock: RealClock | None = None,
                 partitioner: Callable[[str, int], int] | None = None,
                 steal: bool = True, victim_policy: str = "load",
                 min_batch: int = 2, max_batch: int = 4096,
                 transport: str = "pipe", tracer: Tracer | None = None,
                 mp_context: str = "spawn",
                 retry_policy: RetryPolicy | None = None):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        if victim_policy not in ("load", "directory"):
            raise ValueError(f"unknown victim_policy {victim_policy!r}")
        if transport not in ("pipe", "socket"):
            raise ValueError(f"unknown transport {transport!r}; "
                             f"expected 'pipe' or 'socket'")
        self.clock = clock or RealClock()
        if not getattr(self.clock, "threadsafe_post", False):
            raise ValueError("ProcessFederation needs a thread-safe clock "
                             "(RealClock); SimClock runs stay in-process")
        self.n_shards = n_shards
        self.spec = spec or ShardSpec()
        self.partitioner = partitioner or hash_partitioner
        self._partition_on_inputs = getattr(self.partitioner,
                                            "wants_inputs", False)
        self.steal = steal
        self.victim_policy = victim_policy
        self.min_batch = max(1, min_batch)
        self.max_batch = max_batch
        self.tracer = tracer or Tracer(sample_every=64)
        # driver-side bookkeeping (all clock-thread or pre-run only)
        self.tasks_submitted = 0
        self._completed = 0
        self._failed = 0
        self._per_shard_completed = [0] * n_shards
        self.cross_shard_edges = 0
        self._futs: dict[int, DataFuture] = {}       # fid -> driver future
        self._fid_shard: dict[int, int] = {}         # fid -> owning shard
        # shard-death failover (DESIGN.md §14/§15): with a retry budget,
        # tasks lost to a dead shard are re-encoded from their retained
        # raw submit context and re-routed to a surviving shard instead
        # of failing the workflow.  `max_retries=0` restores fail-fast
        # (and skips the retention entirely — no extra memory).
        self.retry_policy = retry_policy or RetryPolicy()
        self._raw: dict[int, tuple] = {}             # fid -> submit context
        self._retries: dict[int, int] = {}           # fid -> failovers used
        self.tasks_failed_over = 0
        self._fwd: dict[int, set[int]] = {}          # fid -> Ref'd shards
        self._inflight_inputs = [dict() for _ in range(n_shards)]
        self._dir = ShardDirectory()                 # parent replica
        self._load = [(0, self.spec.executors)] * n_shards
        self._dead: set[int] = set()
        self._ready_shards: set[int] = set()
        self._await_ready = False
        self._closing = False
        self._stats: dict[int, dict] = {}
        self._stats_pending: set[int] = set()
        # parent-coordinated stealing
        self._steal_reqs: dict[int, tuple[int, int]] = {}
        self._steal_busy: set[int] = set()           # victims mid-request
        self._req_counter = itertools.count(1)
        self.steals = 0
        self.tasks_stolen = 0
        self.restage_bytes_est = 0.0
        self.batch_stat = StreamStat(cap=256)        # tasks per steal batch
        self.restage_stat = StreamStat(cap=256)      # restage bytes/batch
        # per-shard outboxes, flushed one pipe write per clock drain
        self._ob_submit = [[] for _ in range(n_shards)]
        self._ob_resolve = [[] for _ in range(n_shards)]
        self._ob_drop = [[] for _ in range(n_shards)]
        self._ob_flush = [False] * n_shards
        self._transports: list[Optional[ProcessTransport]] = \
            [None] * n_shards
        self._pre_attach: list[list] = [[] for _ in range(n_shards)]
        self._procs: list = []
        self._listener = None
        self._spawn(transport, mp_context)

    # -- process bring-up ----------------------------------------------
    def _spawn(self, transport: str, mp_context: str) -> None:
        import multiprocessing as mp
        ctx = mp.get_context(mp_context)
        if transport == "pipe":
            for i in range(self.n_shards):
                parent_conn, child_conn = ctx.Pipe(duplex=True)
                t = ProcessTransport(parent_conn)
                t.bind(self.clock, None)
                self._transports[i] = t
                p = ctx.Process(target=_shard_main,
                                args=(i, self.spec, ("pipe", child_conn)),
                                daemon=True, name=f"shard{i}")
                p.start()
                child_conn.close()
                t.start(partial(self._on_msg, i), partial(self._on_eof, i))
                self._procs.append(p)
        else:
            self._listener = socket.create_server(("127.0.0.1", 0))
            host, port = self._listener.getsockname()
            for i in range(self.n_shards):
                p = ctx.Process(target=_shard_main,
                                args=(i, self.spec, ("tcp", host, port)),
                                daemon=True, name=f"shard{i}")
                p.start()
                self._procs.append(p)
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="procfed-accept").start()

    def _accept_loop(self) -> None:
        # inbound sockets identify themselves with their first frame; the
        # attach itself happens on the clock thread
        for _ in range(self.n_shards):
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _SockConn(sock)
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                continue
            if msg[0] != "ready":
                conn.close()
                continue
            self.clock.post(partial(self._attach, msg[1],
                                    ProcessTransport(conn)))

    def _attach(self, sid: int, t: ProcessTransport) -> None:
        t.bind(self.clock, None)
        self._transports[sid] = t
        t.start(partial(self._on_msg, sid), partial(self._on_eof, sid))
        self._ready_shards.add(sid)
        self._check_ready()
        pre, self._pre_attach[sid] = self._pre_attach[sid], []
        for m in pre:
            t.send(m)

    # -- outbox ---------------------------------------------------------
    def _send(self, sid: int, msg) -> None:
        t = self._transports[sid]
        if t is None:
            self._pre_attach[sid].append(msg)
        else:
            t.send(msg)

    def _schedule_flush(self, sid: int) -> None:
        if not self._ob_flush[sid]:
            self._ob_flush[sid] = True
            self.clock.schedule(0.0, partial(self._flush_outbox, sid))

    def _flush_outbox(self, sid: int) -> None:
        # submits before resolves before drops: a resolve/drop only exists
        # once its fid resolved driver-side, after which no submit carries
        # a Ref for it — so this grouping preserves the fence invariant
        self._ob_flush[sid] = False
        if sid in self._dead:
            self._ob_submit[sid].clear()
            self._ob_resolve[sid].clear()
            self._ob_drop[sid].clear()
            return
        if self._ob_submit[sid]:
            batch, self._ob_submit[sid] = self._ob_submit[sid], []
            self._send(sid, ("submit", batch))
        if self._ob_resolve[sid]:
            batch, self._ob_resolve[sid] = self._ob_resolve[sid], []
            self._send(sid, ("resolve", batch))
        if self._ob_drop[sid]:
            batch, self._ob_drop[sid] = self._ob_drop[sid], []
            self._send(sid, ("drop", batch))

    # -- submit ---------------------------------------------------------
    def submit(self, name: str, fn=None, args: list | None = None,
               duration: float | None = None, app: str | None = None,
               durable: bool = False, key: str | None = None,
               vmap_key=None, inputs=None) -> DataFuture:
        """Engine-compatible submit.  `fn` and literal args must pickle
        (same contract as `ProcessExecutorPool`); pending-future args are
        encoded as `Ref` markers and resolved cross-process.  `durable`
        and `vmap_key` are accepted for signature compatibility but have
        no process-shard implementation yet."""
        args = args or []
        if key is None:
            key = f"{name}#{self.tasks_submitted}"
        self.tasks_submitted += 1
        tin = ()
        if inputs is not None:
            tin = inputs if type(inputs) is tuple \
                else inputs_of(inputs, *args)
        if self._partition_on_inputs:
            shard = self.partitioner(key, self.n_shards, tin)
        else:
            shard = self.partitioner(key, self.n_shards)
        shard = self._route(shard)
        out = DataFuture(name=name)
        if shard is None:
            self._failed += 1
            out.set_error(TaskFailure("no live shard", kind="host"))
            return out
        fid = out.id
        enc, failed_up = self._encode_args(args, shard)
        if failed_up is not None:
            self._failed += 1
            out.set_error(failed_up)
            return out
        env = (fid, name, fn, enc, duration, app, key,
               tuple((o.name, o.size) for o in tin))
        self._futs[fid] = out
        self._fid_shard[fid] = shard
        if self.retry_policy.max_retries > 0:
            # retain the raw submit context (live future args included) so
            # a shard death can re-encode against the survivors' view
            self._raw[fid] = (name, fn, args, duration, app, key, tin)
        if tin:
            self._inflight_inputs[shard][fid] = env[7]
        self.clock.hold()
        self._ob_submit[shard].append(env)
        self._schedule_flush(shard)
        return out

    def _encode_args(self, args: list, shard: int):
        """Encode call args for the wire: resolved futures inline their
        value, pending futures become `Ref` markers with a resolve
        forward registered toward `shard`.  Returns (enc, failed_up)."""
        enc = []
        for a in args:
            if isinstance(a, DataFuture):
                if a.done:
                    if a.failed:
                        return None, a._error
                    enc.append(a.get())
                else:
                    tgt = self._fwd.get(a.id)
                    if tgt is None:
                        self._fwd[a.id] = tgt = set()
                        a.on_done(self._forward)
                    if shard not in tgt:
                        tgt.add(shard)
                        if self._fid_shard.get(a.id) != shard:
                            self.cross_shard_edges += 1
                    enc.append(Ref(a.id))
            else:
                enc.append(a)
        return enc, None

    def _route(self, shard: int) -> int | None:
        """Remap a partition target off dead shards, deterministically."""
        if shard not in self._dead:
            return shard
        for k in range(1, self.n_shards):
            cand = (shard + k) % self.n_shards
            if cand not in self._dead:
                return cand
        return None

    def _forward(self, fut: DataFuture) -> None:
        """A fid some shard holds a Ref for just resolved: fan the resolve
        envelope out to every registered shard (the fence message)."""
        targets = self._fwd.pop(fut.id, None)
        if not targets:
            return
        if fut.failed:
            err = fut._error
            try:
                pickle.dumps(err)
            except Exception:
                err = TaskFailure(repr(err))
            env = (fut.id, False, err)
        else:
            env = (fut.id, True, fut.get())
        for sid in targets:
            if sid not in self._dead:
                self._ob_resolve[sid].append(env)
                self._schedule_flush(sid)

    # -- inbound messages (clock thread) --------------------------------
    def _on_msg(self, sid: int, msg) -> None:
        tag = msg[0]
        if tag == "done":
            self._on_done(sid, msg[1], msg[2], msg[3])
        elif tag == "load":
            self._load[sid] = (msg[1], msg[2])
            self._maybe_steal()
        elif tag == "dir":
            for op, name in msg[1]:
                if op == "add":
                    self._dir.add(name, sid)
                else:
                    self._dir.drop(name, sid)
        elif tag == "stolen":
            self._on_stolen(sid, msg[1], msg[2], msg[3])
        elif tag == "ready":
            self._ready_shards.add(sid)
            self._check_ready()
        elif tag == "stats":
            self._stats[sid] = msg[1]
            if sid in self._stats_pending:
                self._stats_pending.discard(sid)
                self.clock.release()

    def _on_done(self, sid: int, batch: list, backlog: int,
                 idle: int) -> None:
        for fid, ok, payload in batch:
            fut = self._futs.pop(fid, None)
            owner = self._fid_shard.pop(fid, sid)
            self._raw.pop(fid, None)
            self._retries.pop(fid, None)
            self._inflight_inputs[owner].pop(fid, None)
            if fut is None:
                continue
            # tell the reporting shard it may retire its local handle,
            # unless a resolve envelope (which also retires it) is due
            targets = self._fwd.get(fid)
            if not targets or sid not in targets:
                self._ob_drop[sid].append(fid)
                self._schedule_flush(sid)
            if ok:
                self._completed += 1
                self._per_shard_completed[sid] += 1
                fut.set(payload)
            else:
                self._failed += 1
                fut.set_error(payload)
            self.clock.release()
        self._load[sid] = (backlog, idle)
        self._maybe_steal()

    # -- steal coordination ---------------------------------------------
    def _maybe_steal(self) -> None:
        if not self.steal or self._closing:
            return
        for thief in range(self.n_shards):
            if thief in self._dead:
                continue
            tb, ti = self._load[thief]
            if tb > 0 or ti <= 0:
                continue
            victim = self._pick_victim(thief)
            if victim is None:
                continue
            vb, vi = self._load[victim]
            n = min(vb // 2, self.max_batch)
            if n < 1:
                continue
            req = next(self._req_counter)
            self._steal_reqs[req] = (victim, thief)
            self._steal_busy.add(victim)
            # optimistic load update so one pass doesn't aim every idle
            # thief at the same victim; the reply re-syncs it
            self._load[victim] = (vb - n, vi)
            self._load[thief] = (n, ti)
            self._send(victim, ("steal", req, n))

    def _pick_victim(self, thief: int) -> int | None:
        cands = [s for s in range((self.n_shards))
                 if s != thief and s not in self._dead
                 and s not in self._steal_busy
                 and self._load[s][0] >= max(self.min_batch, 2)]
        if not cands:
            return None
        if self.victim_policy == "load":
            return max(cands, key=lambda s: self._load[s][0])
        maxload = max(self._load[s][0] for s in cands)
        floor = max(self.min_batch, maxload // 2)
        best, best_rank = None, None
        for s in cands:
            if self._load[s][0] < floor:
                continue
            rank = (self._restage_score(s, thief), -self._load[s][0])
            if best is None or rank < best_rank:
                best, best_rank = s, rank
        return best

    def _restage_score(self, victim: int, thief: int) -> float:
        """Average restage bytes over a bounded sample of the victim's
        most recent in-flight inputs, priced on the directory replica."""
        m = self._inflight_inputs[victim]
        if not m:
            return 0.0
        total, k = 0.0, 0
        for fid in reversed(m):
            for name, size in m[fid]:
                if self._dir.holds(name, victim) \
                        and not self._dir.holds(name, thief):
                    total += size
            k += 1
            if k >= 8:
                break
        return total / k

    def _on_stolen(self, victim: int, req_id: int, envs: list,
                   backlog: int) -> None:
        info = self._steal_reqs.pop(req_id, None)
        self._steal_busy.discard(victim)
        self._load[victim] = (backlog, self._load[victim][1])
        if not envs:
            self._maybe_steal()
            return
        thief = info[1] if info else None
        if thief is None or thief in self._dead:
            thief = self._route(victim)
        if thief is None:
            for env in envs:
                fut = self._futs.pop(env[0], None)
                self._fid_shard.pop(env[0], None)
                self._raw.pop(env[0], None)
                self._retries.pop(env[0], None)
                if fut is not None and not fut.done:
                    self._failed += 1
                    fut.set_error(TaskFailure("no live shard for stolen "
                                              "task", kind="host"))
                    self.clock.release()
            return
        restage = 0.0
        for env in envs:
            fid = env[0]
            self._fid_shard[fid] = thief
            # the victim kept a local handle (its dependents); make sure
            # the thief's resolution is forwarded back to retire it
            tgt = self._fwd.get(fid)
            if tgt is None:
                fut = self._futs.get(fid)
                if fut is not None:
                    self._fwd[fid] = tgt = set()
                    fut.on_done(self._forward)
            if tgt is not None:
                tgt.add(victim)
            if env[7]:
                self._inflight_inputs[victim].pop(fid, None)
                self._inflight_inputs[thief][fid] = env[7]
                for name, size in env[7]:
                    if self._dir.holds(name, victim) \
                            and not self._dir.holds(name, thief):
                        restage += size
            self._ob_submit[thief].append(env)
        self._schedule_flush(thief)
        now = self.clock.now()
        self.steals += 1
        self.tasks_stolen += len(envs)
        self.batch_stat.observe(now, len(envs))
        self.restage_bytes_est += restage
        self.restage_stat.observe(now, restage)
        self.tracer.event("steal", now, len(envs))
        self._maybe_steal()

    # -- shard death -----------------------------------------------------
    def _on_eof(self, sid: int) -> None:
        if self._closing:
            # expected exit; just don't hang stats collection on it
            if sid in self._stats_pending:
                self._stats_pending.discard(sid)
                self.clock.release()
            return
        self._shard_died(sid)

    def _shard_died(self, sid: int) -> None:
        if sid in self._dead:
            return
        self._dead.add(sid)
        self._ready_shards.discard(sid)
        t = self._transports[sid]
        if t is not None:
            t.close()
        self.tracer.event("shard_death", self.clock.now(), 1.0)
        doomed = [fid for fid, s in self._fid_shard.items() if s == sid]
        failed_over = 0
        for fid in doomed:
            # failover first (DESIGN.md §14): within the retry budget and
            # with a surviving shard, re-encode the retained submit context
            # and re-route — the driver future (and its dependents' Refs)
            # carries over; the clock hold from submit stays outstanding.
            if self._resubmit(fid, sid):
                failed_over += 1
                continue
            fut = self._futs.pop(fid, None)
            self._fid_shard.pop(fid, None)
            self._raw.pop(fid, None)
            self._retries.pop(fid, None)
            if fut is not None and not fut.done:
                self._failed += 1
                fut.set_error(TaskFailure(
                    f"shard {sid} process died with task in flight",
                    kind="host"))
                self.clock.release()
        if failed_over:
            self.tasks_failed_over += failed_over
            self.tracer.event("task_failover", self.clock.now(),
                              float(failed_over))
        self._inflight_inputs[sid].clear()
        for req, (victim, thief) in list(self._steal_reqs.items()):
            if victim == sid or thief == sid:
                del self._steal_reqs[req]
                self._steal_busy.discard(victim)
        self._ob_submit[sid].clear()
        self._ob_resolve[sid].clear()
        self._ob_drop[sid].clear()
        self._pre_attach[sid].clear()
        self._load[sid] = (0, 0)
        self._check_ready()
        self._maybe_steal()

    def _resubmit(self, fid: int, dead_sid: int) -> bool:
        """Driver-side re-submission of a task lost to a dead shard,
        bounded by ``retry_policy.max_retries``.  Returns True when the
        task was re-routed; False means the caller should fail it fast
        (no retained context, budget exhausted, no survivor, or an
        upstream dependency has itself failed)."""
        raw = self._raw.get(fid)
        if raw is None:
            return False
        used = self._retries.get(fid, 0)
        if used >= self.retry_policy.max_retries:
            return False
        fut = self._futs.get(fid)
        if fut is None or fut.done:
            return False
        target = self._route(dead_sid)
        if target is None:
            return False
        name, fn, args, duration, app, key, tin = raw
        enc, failed_up = self._encode_args(args, target)
        if failed_up is not None:
            # an upstream failed while this task sat on the dead shard:
            # surface that error, as the shard itself would have
            self._futs.pop(fid, None)
            self._fid_shard.pop(fid, None)
            self._raw.pop(fid, None)
            self._retries.pop(fid, None)
            self._failed += 1
            fut.set_error(failed_up)
            self.clock.release()
            return True  # handled: do not also fail with kind="host"
        self._retries[fid] = used + 1
        self._fid_shard[fid] = target
        env = (fid, name, fn, enc, duration, app, key,
               tuple((o.name, o.size) for o in tin))
        if tin:
            self._inflight_inputs[target][fid] = env[7]
        self._ob_submit[target].append(env)
        self._schedule_flush(target)
        return True

    # -- run / shutdown ---------------------------------------------------
    def _check_ready(self) -> None:
        if self._await_ready and \
                len(self._ready_shards) + len(self._dead) >= self.n_shards:
            self._await_ready = False
            self.clock.release()

    def wait_ready(self) -> None:
        """Block until every shard process has booted and said hello (or
        died trying).  Call before timing a workload so interpreter
        spawn cost stays out of the measured window; call it before the
        first `submit` (it runs the clock loop briefly)."""
        if len(self._ready_shards) + len(self._dead) >= self.n_shards:
            return
        self._await_ready = True
        self.clock.hold()
        self.clock.run()

    def run(self) -> None:
        """Block until every submitted task has resolved (one clock hold
        per in-flight task; shard deaths release theirs by failing)."""
        self.clock.run()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop shard processes and collect their telemetry snapshots."""
        if self._closing:
            return
        self._closing = True
        for sid in range(self.n_shards):
            if sid in self._dead:
                continue
            self._flush_outbox(sid)
            self._stats_pending.add(sid)
            self.clock.hold()
            self._send(sid, ("shutdown",))
        if self._stats_pending:
            self.clock.run()               # drains the ("stats", ...) replies
        for p in self._procs:
            p.join(timeout=timeout)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        for t in self._transports:
            if t is not None:
                t.close()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for sid in sorted(self._stats):
            tsnap = self._stats[sid].get("tracer")
            if tsnap:
                self.tracer.merge_snapshot(tsnap)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- aggregates -------------------------------------------------------
    @property
    def tasks_completed(self) -> int:
        return self._completed

    @property
    def tasks_failed(self) -> int:
        return self._failed

    def stats(self) -> dict:
        return {
            "submitted": self.tasks_submitted,
            "completed": self._completed,
            "failed": self._failed,
            "shards": self.n_shards,
            "per_shard_completed": list(self._per_shard_completed),
            "cross_shard_edges": self.cross_shard_edges,
            "failed_over": self.tasks_failed_over,
            "makespan": self.clock.now(),
        }

    def metrics(self) -> dict:
        """Bounded federation snapshot, merged across processes: child
        pool `StreamStat`s fold through `merge`, counters add."""
        io, run = StreamStat(cap=256), StreamStat(cap=256)
        tasks_run = 0
        for snap in self._stats.values():
            p = snap.get("pool") or {}
            tasks_run += p.get("tasks_run", 0)
            if "io_s" in p:
                io.merge(StreamStat.from_snapshot(p["io_s"]))
            if "run_s" in p:
                run.merge(StreamStat.from_snapshot(p["run_s"]))
        return {
            "shards": self.n_shards,
            "dead_shards": sorted(self._dead),
            "submitted": self.tasks_submitted,
            "completed": self._completed,
            "failed": self._failed,
            "failed_over": self.tasks_failed_over,
            "cross_shard_edges": self.cross_shard_edges,
            "stealer": {
                "victim_policy": self.victim_policy,
                "steals": self.steals,
                "tasks_stolen": self.tasks_stolen,
                "restage_bytes_est": self.restage_bytes_est,
                "batch": self.batch_stat.summary(),
                "restage_per_batch": self.restage_stat.summary(),
            },
            "pool": {"tasks_run": tasks_run, "io_s": io.summary(),
                     "run_s": run.summary()},
            "transports": [t.metrics() if t is not None else None
                           for t in self._transports],
            "directory_objects": len(self._dir),
        }

    def report(self) -> RunReport:
        """`RunReport` over the parent tracer after child snapshots were
        merged in `shutdown` (exact counters and event totals are
        federation-wide; sampled spans stay per-process)."""
        return build_report(self.tracer, makespan=self.clock.now())
