"""Kickstart-style provenance records (paper §3.14).

Every task invocation produces an *invocation document* capturing arguments,
host, timings, exit status and retry lineage; records are stored in a
queryable in-memory VDC (virtual data catalog) with optional JSONL
persistence.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
from collections import deque
from typing import Any


@dataclasses.dataclass
class InvocationRecord:
    task_id: str
    name: str
    site: str
    host: str
    submit_time: float
    start_time: float
    end_time: float
    exit_status: str            # ok | failed | retried
    attempt: int
    args_repr: str
    outputs: list[str]
    error: str = ""
    # tracer span id (DESIGN.md §12): links this invocation document to its
    # lifecycle span in the run's trace; "" when tracing is off or the task
    # fell outside the sampling stride
    span_id: str = ""

    @property
    def queue_time(self) -> float:
        return self.start_time - self.submit_time

    @property
    def run_time(self) -> float:
        return self.end_time - self.start_time


class VDC:
    """Virtual data catalog: invocation records + produced-dataset registry.

    Aggregate counters (invocations / ok / queue and run time) are always
    maintained, so `summary()` stays exact even when per-invocation records
    are bounded (``max_records=N`` keeps only the N most recent) or skipped
    entirely (engine ``provenance="summary"`` calls `tally` instead of
    `record`) — the memory-bounded configuration for 10^6-task runs.
    """

    def __init__(self, path: str | None = None,
                 max_records: int | None = None):
        self.records = [] if max_records is None \
            else deque(maxlen=max_records)
        self.datasets: dict[str, dict] = {}
        self.path = path
        self.host = socket.gethostname()
        self._invocations = 0
        self._ok = 0
        self._queue_time = 0.0
        self._run_time = 0.0

    def tally(self, ok: bool, queue_time: float = 0.0,
              run_time: float = 0.0) -> None:
        """Count an invocation without materializing a record."""
        self._invocations += 1
        if ok:
            self._ok += 1
        self._queue_time += queue_time
        self._run_time += run_time

    def record(self, rec: InvocationRecord) -> None:
        self.tally(rec.exit_status == "ok", rec.queue_time, rec.run_time)
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(dataclasses.asdict(rec)) + "\n")

    def register_dataset(self, name: str, producer: str, meta: dict) -> None:
        self.datasets[name] = {"producer": producer, **meta}

    # -- persistence ---------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Write the retained records (one JSON object per line, the same
        shape the ``path=`` append stream produces) plus a trailing
        ``{"_datasets": ...}`` line carrying the dataset registry.
        Returns the number of invocation records written."""
        n = 0
        with open(path, "w", encoding="utf-8") as f:
            for rec in self.records:
                f.write(json.dumps(dataclasses.asdict(rec)) + "\n")
                n += 1
            if self.datasets:
                f.write(json.dumps({"_datasets": self.datasets}) + "\n")
        return n

    @classmethod
    def load_jsonl(cls, path: str,
                   max_records: int | None = None) -> "VDC":
        """Rebuild a VDC from an `export_jsonl` file (or a ``path=`` append
        stream): records are replayed through `record`, so the aggregate
        counters and `summary()` come back exact."""
        vdc = cls(max_records=max_records)
        fields = {f.name for f in dataclasses.fields(InvocationRecord)}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if "_datasets" in obj:
                    vdc.datasets.update(obj["_datasets"])
                    continue
                # tolerate records written by older schemas
                vdc.record(InvocationRecord(
                    **{k: v for k, v in obj.items() if k in fields}))
        return vdc

    # -- queries (paper: "powerful exploration and expressive query") -------
    def by_task(self, name: str) -> list[InvocationRecord]:
        return [r for r in self.records if r.name == name]

    def failures(self) -> list[InvocationRecord]:
        return [r for r in self.records if r.exit_status != "ok"]

    def derivation(self, dataset: str) -> dict:
        """Trace how a dataset was derived (producer chain)."""
        chain = []
        cur = dataset
        seen = set()
        while cur in self.datasets and cur not in seen:
            seen.add(cur)
            info = self.datasets[cur]
            chain.append({"dataset": cur, **info})
            cur = info.get("derived_from", "")
        return {"dataset": dataset, "chain": chain}

    def summary(self) -> dict:
        return {
            "invocations": self._invocations,
            "ok": self._ok,
            "failed": self._invocations - self._ok,
            "total_queue_time": self._queue_time,
            "total_run_time": self._run_time,
        }
