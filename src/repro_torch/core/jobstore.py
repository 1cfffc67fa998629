"""Durable job store (DESIGN.md §15) — sqlite persistence + task state machine.

The engine is an in-memory object; a crash loses every in-flight graph.
This module adds the diracx-shaped durability layer that turns it into a
workflow *system*:

  * `TaskStateMachine` — the explicit per-task status automaton
    (``submitted -> ready -> dispatched -> done|failed|revoked``); illegal
    transitions raise `IllegalTransition`.  Pure in-memory, no I/O — the
    property-testable core.
  * `Journal` — the clock-thread recorder the engine's lifecycle hooks
    call.  It validates every transition through the state machine,
    buffers rows locally, and hands them to the store in batches so the
    per-task hot-path cost is a few dict probes plus one amortized lock
    acquisition per batch.
  * `JobStore` — sqlite tables plus a flat append-only write-ahead log
    (``<db>.log``) owned by a background writer thread.  The *log* is
    the durability hot path: each drain serializes queued batches with
    one ``json.dumps`` per batch and lands them in one ``os.write``, so
    a SIGKILL loses at most the un-flushed tail.  The sqlite tables are
    a *checkpoint* of the log, folded in at natural barriers —
    `load`/`journal_rows`/`close`/crash recovery — never during a run.
    This split is what keeps journaling inside the 5% tracing-overhead
    CI gate on a single core: per-row sqlite work (bind/step/upsert)
    costs ~3 us/row of GIL-holding time that a one-CPU host pays
    directly out of the run wall, while the log append costs ~0.5
    us/row of C-speed serialization.

Durability modes: ``durability="terminal"`` (default) records only
terminal rows (done/failed — what recovery needs); the fold writes them
into the tasks upsert alone.  ``durability="full"`` records every
transition and the fold additionally feeds the append-only journal
table for audit/forensics.

Recovery contract: `JobStore.load(wf_id)` folds the tasks table into a
resume view — a key is *restorable* iff it is durably ``done`` with a
decodable value whose `PhysicalRef`s still exist (same rule as
`RestartLog`); everything else is frontier and re-runs.  Journal rows
carry a per-workflow ``run_id`` so each attempt's transition sequence
replays consistently on its own (see `tests/test_jobstore.py`).
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Iterable

from repro_torch.core.restart_log import decode_value, encode_value, physical_refs

__all__ = [
    "SUBMITTED", "READY", "DISPATCHED", "DONE", "FAILED", "REVOKED",
    "STATUS_NAMES", "TERMINAL", "IllegalTransition", "TaskStateMachine",
    "Journal", "JobStore", "WorkflowState",
]

# status codes — small ints so the hot path compares by identity and the
# sqlite rows stay compact
SUBMITTED, READY, DISPATCHED, DONE, FAILED, REVOKED = range(6)
STATUS_NAMES = ("submitted", "ready", "dispatched", "done", "failed",
                "revoked")
TERMINAL = frozenset((DONE, FAILED))

# current status -> admissible next statuses.  `None` is "never seen".
# Self-loops for SUBMITTED/READY are *idempotent no-ops*, not errors:
# identical (name, args) pairs share a content-derived key, and a stolen
# task re-entering dispatch on the thief shard re-records READY.
_NEXT = {
    None: frozenset((SUBMITTED,)),
    SUBMITTED: frozenset((READY, FAILED)),
    READY: frozenset((DISPATCHED, FAILED)),
    DISPATCHED: frozenset((DONE, FAILED, REVOKED, READY)),
    REVOKED: frozenset((READY,)),
    DONE: frozenset(),
    FAILED: frozenset(),
}
_IDEMPOTENT = frozenset((SUBMITTED, READY))


class IllegalTransition(ValueError):
    """A recorded status change the state machine does not admit."""

    def __init__(self, key: str, cur: int | None, new: int):
        self.key, self.cur, self.new = key, cur, new
        super().__init__(
            f"illegal transition for {key!r}: "
            f"{STATUS_NAMES[cur] if cur is not None else '<new>'} -> "
            f"{STATUS_NAMES[new]}")


class TaskStateMachine:
    """Per-task status automaton; pure in-memory, no I/O.

    ``advance(key, status)`` returns True when the state changed, False
    for an idempotent re-record (duplicate submit of a shared key,
    ready-after-steal), and raises `IllegalTransition` otherwise.

    Example::

        sm = TaskStateMachine()
        sm.advance("k", SUBMITTED); sm.advance("k", READY)
        sm.advance("k", DISPATCHED); sm.advance("k", DONE)
        sm.advance("k", READY)   # raises IllegalTransition (done is final)
    """

    __slots__ = ("state", "duplicates")

    def __init__(self, seed: dict[str, int] | None = None):
        self.state: dict[str, int] = dict(seed) if seed else {}
        self.duplicates = 0

    def advance(self, key: str, status: int) -> bool:
        cur = self.state.get(key)
        if cur == status:
            if status in _IDEMPOTENT:
                self.duplicates += 1
                return False
            raise IllegalTransition(key, cur, status)
        if status not in _NEXT[cur]:
            raise IllegalTransition(key, cur, status)
        self.state[key] = status
        return True

    def counts(self) -> dict[str, int]:
        out = dict.fromkeys(STATUS_NAMES, 0)
        for s in self.state.values():
            out[STATUS_NAMES[s]] += 1
        return out

    def frontier(self) -> list[str]:
        """Keys not in a terminal state — what a resume must re-run."""
        return [k for k, s in self.state.items() if s not in TERMINAL]


class Journal:
    """Clock-thread transition recorder feeding a `JobStore`.

    Created via `JobStore.journal()` and attached as ``engine.journal``;
    the engine's lifecycle hooks call the ``task_*`` methods (clock
    thread only — same single-writer contract as the tracer).  Rows
    buffer locally and flush to the store every `batch` records; callers
    owning a natural barrier (end of run, workflow sealed) should call
    `flush()` so the tail is not stranded until close.
    """

    __slots__ = ("store", "sm", "_batch", "full", "_local", "rows_queued",
                 "flushes", "tracer", "clock", "default_wf", "_occ")

    def __init__(self, store: "JobStore", batch: int = 64,
                 durability: str = "terminal", tracer=None, clock=None,
                 default_wf: str = ""):
        if durability not in ("terminal", "full"):
            raise ValueError(f"durability must be terminal|full, "
                             f"got {durability!r}")
        self.store = store
        self.default_wf = default_wf
        self.sm = TaskStateMachine()
        self._batch = batch
        self.full = durability == "full"
        self._local: list = []
        self.rows_queued = 0
        self.flushes = 0
        self.tracer = tracer
        self.clock = clock
        self._occ: dict[str, int] = {}

    def unique_key(self, base: str) -> str:
        """Disambiguate a content-derived key: the store's primary key is
        (wf, key), so two live submissions of the same (name, args) must
        not share a row.  Occurrence order is submission order, which a
        deterministic program reproduces on resume, so the n-th duplicate
        maps to the same durable row across runs."""
        occ = self._occ
        n = occ.get(base)
        if n is None:
            occ[base] = 1
            return base
        occ[base] = n + 1
        return f"{base}~{n}"

    # -- engine lifecycle hooks (clock thread only) --------------------
    # Terminal durability is the throughput mode (the <=5% gate in
    # benchmarks/observability.py): the engine skips the non-terminal
    # hooks entirely (gated on `self.full`) and the terminal hooks skip
    # the state machine, leaving one tuple-append per completion on the
    # hot path.  Full durability runs every hook through `sm.advance`,
    # so illegal transitions are rejected at the source; terminal-mode
    # journals get the same enforcement at replay (`JobStore.load`).
    def task_submitted(self, key: str) -> None:
        if self.sm.advance(key, SUBMITTED) and self.full:
            self._add(key, SUBMITTED, None, None)

    def task_ready(self, key: str) -> None:
        if self.sm.advance(key, READY) and self.full:
            self._add(key, READY, None, None)

    def task_dispatched(self, key: str) -> None:
        if self.sm.advance(key, DISPATCHED) and self.full:
            self._add(key, DISPATCHED, None, None)

    def task_revoked(self, key: str) -> None:
        if self.sm.advance(key, REVOKED) and self.full:
            self._add(key, REVOKED, None, None)

    def task_done(self, key: str, value: Any) -> None:
        if self.full:
            self.sm.advance(key, DONE)
        self._add(key, DONE, value, None)

    def task_failed(self, key: str, error: str) -> None:
        if self.full:
            self.sm.advance(key, FAILED)
        self._add(key, FAILED, None, str(error))

    # ------------------------------------------------------------------
    def _add(self, key: str, status: int, value, error) -> None:
        self._local.append((key, status, value, error))
        if len(self._local) >= self._batch:
            self.flush()

    def flush(self) -> None:
        """Hand the local buffer to the store's writer queue (one lock)."""
        rows = self._local
        if not rows:
            return
        self._local = []
        self.rows_queued += len(rows)
        self.flushes += 1
        self.store.enqueue_rows(rows, self.default_wf, full=self.full)
        tr = self.tracer
        if tr is not None and self.clock is not None:
            tr.event("journal_flush", self.clock.now(), float(len(rows)))


class WorkflowState:
    """Folded durable state of one workflow, as `JobStore.load` returns it.

    ``done`` maps task key -> decoded value for every durably completed
    task whose value survived encoding and whose `PhysicalRef`s still
    exist; ``failed`` maps key -> error string; ``counts`` tallies rows
    per status name; ``run_id`` is the attempt counter recorded so far.
    """

    __slots__ = ("wf_id", "done", "failed", "counts", "run_id")

    def __init__(self, wf_id: str, done: dict, failed: dict,
                 counts: dict, run_id: int):
        self.wf_id, self.done, self.failed = wf_id, done, failed
        self.counts, self.run_id = counts, run_id


_SCHEMA = """
CREATE TABLE IF NOT EXISTS workflows(
    wf_id TEXT PRIMARY KEY, name TEXT, status TEXT DEFAULT 'running',
    runs INTEGER DEFAULT 0, created_wall REAL, updated_wall REAL);
CREATE TABLE IF NOT EXISTS tasks(
    wf_id TEXT NOT NULL, key TEXT NOT NULL, run_id INTEGER,
    status INTEGER NOT NULL, value TEXT, error TEXT, wall REAL,
    PRIMARY KEY (wf_id, key)) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS journal(
    seq INTEGER PRIMARY KEY AUTOINCREMENT, wf_id TEXT, run_id INTEGER,
    key TEXT, status INTEGER, value TEXT, error TEXT, wall REAL);
CREATE INDEX IF NOT EXISTS journal_wf ON journal(wf_id, seq);
"""

# tasks upsert: the materialized latest-status row.  A done-with-value row
# is never demoted by a non-terminal row (a changed program resubmitting a
# completed key must not erase its durable value); everything else — new
# runs re-running failed or value-less keys included — overwrites.
_UPSERT = """
INSERT INTO tasks(wf_id, key, run_id, status, value, error, wall)
VALUES(?, ?, ?, ?, ?, ?, ?)
ON CONFLICT(wf_id, key) DO UPDATE SET
    run_id=excluded.run_id, status=excluded.status, value=excluded.value,
    error=excluded.error, wall=excluded.wall
WHERE NOT (tasks.status = 3 AND tasks.value IS NOT NULL
           AND excluded.status NOT IN (3, 4))
"""


def _encode_op(op) -> str:
    """One write-ahead-log line for a queued op.  The fast path is a
    single ``json.dumps`` of the whole batch with raw values; batches
    holding non-JSON values (PhysicalRefs, arbitrary objects) fall back
    to per-row encoding, where a value that even `encode_value` cannot
    make durable is dropped and the row grows a 5th element as the
    marker (folded as value-less: the task re-runs on resume).  Raw and
    encoded rows fold identically because `encode_value` is identity on
    JSON round-tripped data."""
    kind, payload, wall = op
    if kind == "wf":
        return json.dumps(["w", wall, payload[0], payload[1]])
    rows, default_wf, full = payload
    flag = 1 if full else 0
    try:
        return json.dumps(["r", wall, default_wf, flag, rows])
    except (TypeError, ValueError):
        safe = []
        for key, status, value, error in rows:
            try:
                enc = encode_value(value)
                json.dumps(enc)
                safe.append([key, status, enc, error])
            except (TypeError, ValueError):
                safe.append([key, status, None, error, 0])
        return json.dumps(["r", wall, default_wf, flag, safe])


def _read_log(path: str) -> list:
    """Parse a write-ahead log back into the writer-queue op shape.
    Stops at the first unparsable line (a torn tail from an OS-level
    crash; SIGKILL cannot tear a single ``os.write``)."""
    ops: list = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = f.read()
    except OSError:
        return ops
    for line in data.splitlines():
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break
        if rec[0] == "r":
            ops.append(("rows", (rec[4], rec[2], bool(rec[3])), rec[1]))
        else:
            ops.append(("wf", (rec[2], rec[3]), rec[1]))
    return ops


class JobStore:
    """Persistent job store: append-only log hot path + sqlite checkpoint.

    All writes are batched off the hot path: `Journal.flush` appends row
    batches to an in-memory queue under a plain lock; a daemon writer
    thread drains the queue every wakeup (`flush_interval` seconds, or
    sooner past `flush_max` queued rows) into the write-ahead log file
    ``<path>.log`` — one JSON line per batch, one ``os.write`` per
    drain.  Drained batches also stay queued in writer memory and are
    folded into the sqlite tables only at barriers (`checkpoint`, which
    `load`/`journal_rows` call, and `close`); a fresh `JobStore` over a
    database whose owner was SIGKILLed replays the surviving log tail
    into sqlite before serving reads.  An in-memory store
    (``":memory:"``) has no log file and folds each drain directly.

    Example::

        store = JobStore("run.db")
        eng = Engine(clock)
        eng.journal = store.journal(default_wf="demo")
        ... run ...
        eng.journal.flush(); store.sync()   # log-durable past here
        state = store.load("demo")      # -> WorkflowState(done={...})
    """

    def __init__(self, path: str, flush_interval: float = 0.05,
                 flush_max: int = 4096):
        self.path = path
        self.flush_interval = flush_interval
        self.flush_max = flush_max
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=10.0)
        self._dblock = threading.Lock()
        with self._dblock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()
        self._run_ids: dict[str, int] = {}
        self._qlock = threading.Lock()
        self._cv = threading.Condition(self._qlock)
        self._queue: list = []          # ("rows", batch, wall) | ("wf", ...)
        self._pending: list = []        # logged, not yet folded (writer only)
        self._enqueued = 0
        self._committed = 0
        self._closed = False
        self._ckpt_req = False
        self._ckpt_gen = 0
        self._wake = threading.Event()
        self.batches_committed = 0
        self._log_path = None if path == ":memory:" else path + ".log"
        self._log_fd = None
        if self._log_path is not None:
            self._recover_log()
            self._log_fd = os.open(self._log_path,
                                   os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                                   0o644)
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="jobstore-writer", daemon=True)
        self._writer.start()

    def _recover_log(self) -> None:
        """Crash recovery: fold a leftover log tail from a previous owner
        into sqlite, then truncate it.  Runs before the writer starts."""
        ops = _read_log(self._log_path)
        if ops:
            self._fold_ops(ops)
        if os.path.exists(self._log_path):
            with open(self._log_path, "w"):
                pass

    # -- workflow registry ---------------------------------------------
    def begin_run(self, wf_id: str, name: str | None = None) -> int:
        """Register (or re-open) a workflow and bump its attempt counter."""
        wall = time.time()
        with self._dblock:
            self._conn.execute(
                "INSERT INTO workflows(wf_id, name, status, runs, "
                "created_wall, updated_wall) VALUES(?, ?, 'running', 1, ?, ?) "
                "ON CONFLICT(wf_id) DO UPDATE SET runs=workflows.runs+1, "
                "status='running', updated_wall=excluded.updated_wall",
                (wf_id, name or wf_id, wall, wall))
            self._conn.commit()
            run_id = self._conn.execute(
                "SELECT runs FROM workflows WHERE wf_id=?",
                (wf_id,)).fetchone()[0]
        with self._qlock:
            self._run_ids[wf_id] = run_id
        return run_id

    def journal(self, batch: int = 64, durability: str = "terminal",
                default_wf: str = "", tracer=None, clock=None) -> Journal:
        """Create a `Journal` feeding this store (see class docstring).

        ``default_wf`` names the workflow for keys without a ``wf::``
        prefix; it is registered via `begin_run` on first use here.
        """
        if default_wf not in self._run_ids:
            self.begin_run(default_wf)
        return Journal(self, batch=batch, durability=durability,
                       tracer=tracer, clock=clock, default_wf=default_wf)

    # -- writer queue ---------------------------------------------------
    def enqueue_rows(self, rows: list, default_wf: str = "",
                     full: bool = False) -> None:
        """Queue a batch of (key, status, value, error) rows (any thread).
        Keys without a ``wf::`` prefix are attributed to `default_wf`.
        ``full`` batches additionally land in the append-only journal
        table (audit trail) when folded; terminal batches fold only into
        the tasks upsert."""
        with self._qlock:
            if self._closed:
                raise RuntimeError("JobStore is closed")
            self._queue.append(("rows", (rows, default_wf, full),
                                time.time()))
            self._enqueued += len(rows)
            backlog = self._enqueued - self._committed
        if backlog >= self.flush_max:
            self._wake.set()

    def set_workflow_status(self, wf_id: str, status: str) -> None:
        """Queue a workflow status change ('running'|'done'|'failed')."""
        with self._qlock:
            if self._closed:
                raise RuntimeError("JobStore is closed")
            self._queue.append(("wf", (wf_id, status), time.time()))
            self._enqueued += 1   # counts as one op for sync() accounting

    def _writer_loop(self) -> None:
        while True:
            self._wake.wait(self.flush_interval)
            self._wake.clear()
            self._flush_once()
            with self._qlock:
                ckpt = self._ckpt_req
                done = self._closed and not self._queue
            if ckpt or done:
                self._checkpoint_writer()
            if done:
                if self._log_fd is not None:
                    os.close(self._log_fd)
                    self._log_fd = None
                    try:
                        os.unlink(self._log_path)
                    except OSError:
                        pass
                break

    def _flush_once(self) -> None:
        """Drain the queue: append every op to the log (one JSON line per
        op, one ``os.write`` for the drain) and stash it for the next
        fold.  This is the only work the writer does while a run is hot —
        per-row sqlite cost would come straight out of the run wall on a
        single-core host (the writer shares the GIL and the CPU with the
        clock thread)."""
        with self._qlock:
            if not self._queue:
                return
            ops, self._queue = self._queue, []
        n_rows = 0
        if self._log_fd is not None:
            lines = []
            for op in ops:
                kind, payload, _wall = op
                n_rows += len(payload[0]) if kind == "rows" else 1
                lines.append(_encode_op(op))
            os.write(self._log_fd, ("\n".join(lines) + "\n").encode())
            self._pending.extend(ops)
        else:                           # :memory: — no log, fold directly
            for kind, payload, _wall in ops:
                n_rows += len(payload[0]) if kind == "rows" else 1
            self._fold_ops(ops)
        with self._qlock:
            self._committed += n_rows
            self.batches_committed += 1
            self._cv.notify_all()

    def _checkpoint_writer(self) -> None:
        """Writer-thread half of `checkpoint`: fold everything logged so
        far into sqlite and truncate the log.  Single-threaded with the
        log/pending state by construction."""
        ops, self._pending = self._pending, []
        if ops:
            self._fold_ops(ops)
        if self._log_fd is not None:
            os.ftruncate(self._log_fd, 0)
        with self._qlock:
            self._ckpt_req = False
            self._ckpt_gen += 1
            self._cv.notify_all()

    def _fold_ops(self, ops: list) -> None:
        """Fold queued/logged ops into the sqlite tables (one transaction).
        Ops carry either raw in-process values or their JSON round-trips
        from a recovered log; `encode_value` is identity on the latter, so
        both encode to the same durable text."""
        with self._qlock:
            overlay = dict(self._run_ids)
        with self._dblock:
            run_ids = dict(self._conn.execute(
                "SELECT wf_id, runs FROM workflows").fetchall())
        run_ids.update(overlay)
        task_rows, journal_rows, wf_rows = [], [], []
        get_run = run_ids.get
        dumps = json.dumps
        for kind, payload, wall in ops:
            if kind == "wf":
                wf_rows.append((payload[1], wall, payload[0]))
                continue
            rows, default_wf, full = payload
            for row in rows:
                key, status, value, error = row[0], row[1], row[2], row[3]
                wf_id, sep, _ = key.partition("::")
                if not sep:
                    wf_id = default_wf
                enc = None
                # len(row) == 5 marks a value dropped at log time as
                # non-serializable: persist value-less, re-run on resume
                if status == DONE and len(row) == 4:
                    if value is None:
                        enc = "null"
                    elif type(value) in (int, float, str, bool):
                        enc = dumps(value)
                    else:
                        try:
                            enc = dumps(encode_value(value))
                        except (TypeError, ValueError):
                            enc = None  # non-durable value: re-run on resume
                task_rows.append((wf_id, key, get_run(wf_id, 0), status,
                                  enc, error, wall))
            if full:
                journal_rows.extend(task_rows[-len(rows):])
        with self._dblock:
            cur = self._conn.cursor()
            if journal_rows:
                cur.executemany(
                    "INSERT INTO journal(wf_id, key, run_id, status, value, "
                    "error, wall) VALUES(?, ?, ?, ?, ?, ?, ?)", journal_rows)
            if task_rows:
                cur.executemany(_UPSERT, task_rows)
            for status, wall, wf_id in wf_rows:
                cur.execute(
                    "UPDATE workflows SET status=?, updated_wall=? "
                    "WHERE wf_id=?", (status, wall, wf_id))
            self._conn.commit()

    def sync(self, timeout: float = 30.0) -> None:
        """Block until every op enqueued so far is durable — appended to
        the write-ahead log (or folded into sqlite for an in-memory
        store).  A SIGKILL after `sync` returns loses nothing."""
        deadline = time.monotonic() + timeout
        self._wake.set()
        with self._qlock:
            target = self._enqueued
            while self._committed < target:
                if time.monotonic() > deadline:
                    raise TimeoutError("JobStore.sync timed out")
                self._cv.wait(0.05)
                self._wake.set()

    def checkpoint(self, timeout: float = 60.0) -> None:
        """Fold everything enqueued so far into the sqlite tables and
        truncate the log.  `load` and `journal_rows` call this so reads
        always see a folded view; during a run nothing calls it — the
        log alone carries durability until a barrier."""
        with self._qlock:
            if self._closed:
                return                  # close() already folded everything
        self.sync(timeout)
        deadline = time.monotonic() + timeout
        with self._qlock:
            gen = self._ckpt_gen
            self._ckpt_req = True
        self._wake.set()
        with self._qlock:
            while self._ckpt_gen == gen:
                if time.monotonic() > deadline:
                    raise TimeoutError("JobStore.checkpoint timed out")
                self._cv.wait(0.05)
                self._wake.set()

    def close(self) -> None:
        """Flush and fold everything, stop the writer thread, remove the
        (now redundant) log, and close the connection — the sqlite
        database alone is the complete durable state afterwards."""
        with self._qlock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._writer.join(timeout=30.0)
        with self._dblock:
            self._conn.commit()
            self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- recovery / inspection -----------------------------------------
    def load(self, wf_id: str) -> WorkflowState:
        """Fold the durable tasks table into a resume view (see module
        docstring for the restorability rule).  Checkpoints first so the
        view includes everything log-durable at the time of the call."""
        self.checkpoint()
        with self._dblock:
            rows = self._conn.execute(
                "SELECT key, status, value, error FROM tasks WHERE wf_id=?",
                (wf_id,)).fetchall()
            wf = self._conn.execute(
                "SELECT runs FROM workflows WHERE wf_id=?",
                (wf_id,)).fetchone()
        done, failed = {}, {}
        counts = dict.fromkeys(STATUS_NAMES, 0)
        for key, status, value, error in rows:
            counts[STATUS_NAMES[status]] += 1
            if status == DONE and value is not None:
                decoded = decode_value(json.loads(value))
                if all(r.exists() for r in physical_refs(decoded)):
                    done[key] = decoded
            elif status == FAILED:
                failed[key] = error or ""
        return WorkflowState(wf_id, done, failed, counts,
                             wf[0] if wf else 0)

    def import_restart_log(self, log, wf_id: str = "") -> int:
        """Seed the store from an existing `RestartLog` (migration path:
        recovery replays the restart log *and* the journal).  Returns the
        number of imported entries."""
        wall = time.time()
        if wf_id not in self._run_ids:
            self.begin_run(wf_id)
        run_id = self._run_ids[wf_id]
        prefix = f"{wf_id}::" if wf_id else ""
        n = 0
        with self._dblock:
            for key, value in log.items():
                try:
                    enc = json.dumps(encode_value(value))
                except (TypeError, ValueError):
                    continue
                self._conn.execute(_UPSERT, (wf_id, prefix + key, run_id,
                                             DONE, enc, None, wall))
                n += 1
            self._conn.commit()
        return n

    def journal_rows(self, wf_id: str, run_id: int | None = None) -> list:
        """The append-only journal for a workflow (optionally one run),
        in sequence order, as (run_id, key, status) tuples.  Only
        ``durability="full"`` journals feed this table; terminal-mode
        durable state lives in the tasks upsert alone."""
        self.checkpoint()
        q = ("SELECT run_id, key, status FROM journal WHERE wf_id=? "
             "ORDER BY seq")
        args: tuple = (wf_id,)
        if run_id is not None:
            q = ("SELECT run_id, key, status FROM journal "
                 "WHERE wf_id=? AND run_id=? ORDER BY seq")
            args = (wf_id, run_id)
        with self._dblock:
            return self._conn.execute(q, args).fetchall()

    @staticmethod
    def peek(path: str, wf_id: str = "") -> dict[str, int]:
        """Read-only progress poll usable from *another process* while the
        owning process is live (WAL readers never block the writer, and
        log readers just scan a flat file).  Returns durable per-status
        counts for `wf_id`: the folded sqlite tables plus each key's
        last status in the un-folded log tail.  Exact for terminal
        statuses (a key's done/failed row lands exactly once across the
        two sources); a full-durability key whose early transitions were
        checkpointed while later ones sit in the log is counted in both
        sources' non-terminal buckets, so those are an estimate."""
        conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True, timeout=5.0)
        try:
            rows = conn.execute(
                "SELECT status, COUNT(*) FROM tasks WHERE wf_id=? "
                "GROUP BY status", (wf_id,)).fetchall()
        finally:
            conn.close()
        out = dict.fromkeys(STATUS_NAMES, 0)
        for status, n in rows:
            out[STATUS_NAMES[status]] = n
        last: dict[str, int] = {}
        for kind, payload, _wall in _read_log(path + ".log"):
            if kind != "rows":
                continue
            batch, default_wf, _full = payload
            for row in batch:
                key = row[0]
                wf, sep, _ = key.partition("::")
                if (wf if sep else default_wf) == wf_id:
                    last[key] = row[1]
        for status in last.values():
            out[STATUS_NAMES[status]] += 1
        return out
