"""Durable workflow service (DESIGN.md §15) — multi-tenant submission +
crash recovery over the existing engine.

`WorkflowService` is the thin layer that turns "one in-memory engine"
into "a system many users submit to and a crash cannot erase":

  * every task's status transitions are journaled through the engine's
    `journal` hook into a sqlite `JobStore` (WAL mode, batched writes off
    the hot path);
  * each `open()` returns a `WorkflowHandle` whose procedures submit
    under a ``<wf_id>::``-prefixed dataflow-stable key and under the
    tenant's app bucket, so per-app fair share (stride-scheduled
    `ReadyQueue` draining) divides pool throughput by `share=` weights;
  * re-opening a workflow against a store that already holds rows
    *resumes* it: durably-done values resolve immediately through a
    `ResumeView` (the RestartLog seam) and only the remaining frontier
    re-runs.

Example — run, crash (or just exit), resume::

    store = JobStore("runs.db")
    svc = WorkflowService(Engine(clock), store)
    h = svc.open("etl")                   # or re-open after a crash
    stage = h.wf.atomic(fn=work, name="stage")
    h.seal(h.wf.gather([stage(i) for i in range(1000)]))
    svc.run()                             # resumed keys restore instantly
    results = h.result(); print(h.restored, "restored")

Works over a `FederatedEngine` too (the journal and resume view are
shared by every shard; keys are shard-agnostic).  `ProcessFederation` is
not supported — its tasks run in child processes whose engines cannot
reach the parent's store.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.futures import DataFuture
from repro_torch.core.jobstore import JobStore, Journal
from repro_torch.core.restart_log import physical_refs
from repro_torch.core.workflow import Workflow

__all__ = ["WorkflowService", "WorkflowHandle", "ResumeView"]

_MISS = object()


class ResumeView:
    """Durably-completed values, presented through the `RestartLog` seam
    (``lookup``/``append``) so the engine's restore path needs no new
    code.  ``append`` is a no-op — the journal is the persistence path.
    Per-workflow restore hits are tallied for `WorkflowHandle.restored`.
    """

    def __init__(self):
        self._done: dict[str, Any] = {}
        self.hits: dict[str, int] = {}

    def add(self, done: dict[str, Any]) -> None:
        self._done.update(done)

    def lookup(self, key: str):
        value = self._done.get(key, _MISS)
        if value is _MISS:
            return False, None
        for ref in physical_refs(value):
            if not ref.exists():
                return False, None
        wf_id, _, _ = key.partition("::")
        self.hits[wf_id] = self.hits.get(wf_id, 0) + 1
        return True, value

    def append(self, key: str, value) -> None:
        pass

    def __len__(self):
        return len(self._done)


class WorkflowHandle:
    """One tenant workflow opened through the service.

    ``wf`` is the `Workflow` DSL object to build the program on; `seal`
    registers the program's final output future so the workflow's
    durable status flips to done/failed (and the journal tail flushes)
    the moment it resolves.
    """

    def __init__(self, service: "WorkflowService", wf_id: str,
                 wf: Workflow, run_id: int):
        self.service = service
        self.wf_id = wf_id
        self.wf = wf
        self.run_id = run_id
        self._out: DataFuture | None = None

    def seal(self, out: DataFuture) -> DataFuture:
        """Declare `out` the workflow's final output; returns it."""
        self._out = out
        out.on_done(self._finished)
        return out

    def _finished(self, f: DataFuture) -> None:
        # clock thread: flush the journal tail so the terminal rows are
        # queued before the status row, then mark the workflow itself
        self.service.journal.flush()
        self.service.store.set_workflow_status(
            self.wf_id, "failed" if f.failed else "done")

    def result(self):
        if self._out is None:
            raise RuntimeError(f"workflow {self.wf_id!r} was never sealed")
        return self._out.get()

    @property
    def restored(self) -> int:
        """Tasks resolved from the store instead of re-running."""
        return self.service.resume_view.hits.get(self.wf_id, 0)

    def counts(self) -> dict[str, int]:
        """Durable per-status row counts (post-`sync` view)."""
        return JobStore.peek(self.service.store.path, self.wf_id)


class WorkflowService:
    """Multi-tenant, durable submission API over an `Engine` or
    `FederatedEngine` (see module docstring).

    The service owns the engine's `journal` and `restart_log` seams and
    enables `fair_share`; it refuses an engine whose seams are already
    occupied rather than silently replacing them.  `durability` and
    `journal_batch` pass through to `JobStore.journal`.
    """

    def __init__(self, engine, store: JobStore, fair_share: bool = True,
                 durability: str = "terminal", journal_batch: int = 64,
                 tracer=None):
        self.engine = engine
        self.store = store
        self.resume_view = ResumeView()
        tracer = tracer if tracer is not None \
            else getattr(engine, "tracer", None)
        self.journal: Journal = store.journal(
            batch=journal_batch, durability=durability, tracer=tracer,
            clock=engine.clock)
        self._handles: dict[str, WorkflowHandle] = {}
        shards = getattr(engine, "shards", None)
        for eng in (shards if shards is not None else [engine]):
            if eng.journal is not None or eng.restart_log is not None:
                raise ValueError(
                    "engine already has a journal/restart_log attached; "
                    "the service must own both seams")
            eng.journal = self.journal
            eng.restart_log = self.resume_view
            eng.fair_share = fair_share

    # ------------------------------------------------------------------
    def open(self, name: str, wf_id: str | None = None,
             app: str | None = None, share: float = 1.0,
             resume: bool = True) -> WorkflowHandle:
        """Open (or re-open) a workflow; returns its `WorkflowHandle`.

        With ``resume=True`` the store's durable state for `wf_id` is
        folded into the resume view first, so re-building the same
        program restores completed tasks.  `share` is the tenant's
        fair-share weight (relative to other apps' weights).
        """
        wf_id = wf_id or name
        if wf_id in self._handles:
            raise ValueError(f"workflow {wf_id!r} already open")
        if "::" in wf_id:
            raise ValueError("wf_id must not contain '::'")
        run_id = self.store.begin_run(wf_id, name=name)
        restorable = 0
        if resume:
            state = self.store.load(wf_id)
            restorable = len(state.done)
            self.resume_view.add(state.done)
        app = app or wf_id
        for eng in self._engines():
            eng.app_shares[app] = share
        wf = Workflow(name, self.engine, key_prefix=f"{wf_id}::",
                      default_app=app)
        handle = WorkflowHandle(self, wf_id, wf, run_id)
        self._handles[wf_id] = handle
        tr = self.journal.tracer
        if tr is not None and restorable:
            tr.event("wf_resume", self.engine.clock.now(),
                     float(restorable))
        return handle

    def _engines(self):
        shards = getattr(self.engine, "shards", None)
        return shards if shards is not None else [self.engine]

    # ------------------------------------------------------------------
    def run(self) -> None:
        """Drive the engine until the graph drains, then make everything
        journaled so far durable (`Journal.flush` + `JobStore.sync`)."""
        self.engine.run()
        self.sync()

    def sync(self) -> None:
        """Flush the journal tail and block until the store is durable
        (append-log landed; sqlite folds at the next barrier)."""
        self.journal.flush()
        self.store.sync()
        tr = self.journal.tracer
        if tr is not None:
            tr.gauge("tasks_restored",
                     sum(self.resume_view.hits.values()))
            tr.gauge("journal_rows", self.journal.rows_queued)
            tr.gauge("journal_duplicates", self.journal.sm.duplicates)

    def status(self, wf_id: str) -> dict:
        """Durable view of one workflow: status, runs, per-status counts."""
        self.sync()
        state = self.store.load(wf_id)
        return {"wf_id": wf_id, "run_id": state.run_id,
                "counts": state.counts, "done": len(state.done),
                "failed": len(state.failed)}

    def close(self) -> None:
        """Flush + sync and detach from the engine (store stays open)."""
        self.sync()
        for eng in self._engines():
            if eng.journal is self.journal:
                eng.journal = None
            if eng.restart_log is self.resume_view:
                eng.restart_log = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
