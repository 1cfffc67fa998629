"""The program's own spans in the traced slice: device time and idle gaps
by the `repro.*` range that launched them.

While the profiler records, the port opens a `repro.*` range at each layer
boundary of its steps (`repro_torch/models/spans.py`); the CUDA calls it
makes nest in those ranges on the host thread, on the profiler's clock.
CUPTI gives each device op (kernel, copy, set) the correlation id of the
call that launched it (any `cuda_runtime` or `cuda_driver` call:
`cudaLaunch*`, `cuLaunch*`, `cudaMemcpyAsync`, `cudaMemsetAsync`), so an op
belongs to every `repro.*` range that holds its call on the call's thread:
a child's ops count under its parent too.  Ops and gaps are clipped to the
slice as `harness/trace.py` clips them (between the two marker kernels).

Only the Chrome trace that `runner.run_cell` writes is read, never the
program.  A trace with no device op (no card) or no `repro.*` range (a
program that opens none) gives nothing.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

from portbench.harness.stats import union_length
from portbench.harness.trace import DEVICE_CATS, MARKER, Trace

PREFIX = "repro."
CALL_CATS = ("cuda_runtime", "cuda_driver")


def _corr(e):
    return e.get("args", {}).get("correlation")


def _owners(events) -> dict:
    """correlation id -> the names of the `repro.*` ranges that hold the
    CUDA call of that id on its thread, outermost first."""
    by_thread = {}
    for i, e in enumerate(events):
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            item = (e["ts"], 0, -e["dur"], i)           # at one time: outer range, inner, call
        elif cat in CALL_CATS and _corr(e) is not None:
            item = (e["ts"], 1, 0, i)
        else:
            continue
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(item)
    owner = {}
    for items in by_thread.values():
        stack = []                                      # (name, end) of the open ranges
        for ts, kind, _, i in sorted(items):
            while stack and stack[-1][1] <= ts:
                stack.pop()
            e = events[i]
            if kind == 0:
                stack.append((e["name"], e["ts"] + e["dur"]))
            else:
                owner[_corr(e)] = tuple(n for n, _ in stack)
    return owner


class Spans:
    """One traced slice's device ops, each with the spans that launched it
    (times in seconds)."""

    def __init__(self, events: list[dict]):
        events = [e for e in events if "dur" in e and "ts" in e]
        trace = Trace(events)
        self.t0, self.t1 = trace.t0, trace.t1
        self.ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"
                       and e.get("name", "").startswith(PREFIX)}
        owner = _owners(events)
        self.ops = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, owner.get(_corr(e), ()))
                          for e in events if e.get("cat") in DEVICE_CATS
                          and MARKER not in e.get("name", ""))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def device_s(self, name: str) -> float:
        """Seconds of the slice in which some op launched inside a `name`
        range ran (the union of their intervals)."""
        return union_length([(s, e) for s, e, names in self.ops if name in names],
                            self.t0, self.t1)

    def gaps(self) -> list[tuple[float, str | None]]:
        """(seconds, span) of each idle gap of the device in the slice, in
        time order: the gaps `stats.gaps` finds, each given the innermost
        span of the op that ends it; None where that op was launched
        outside every span, or where the slice's end ends the gap."""
        out, cur = [], self.t0
        for s, e, names in self.ops:
            if s > cur:
                end = min(s, self.t1)
                out.append((end - cur, names[-1] if names and s < self.t1 else None))
            cur = max(cur, e)
            if cur >= self.t1:
                break
        if cur < self.t1:
            out.append((self.t1 - cur, None))
        return [g for g in out if g[0] > 0]

    @property
    def program_idle_s(self) -> float:
        """Idle seconds whose ending op the program launched inside a span."""
        return sum(g for g, name in self.gaps() if name is not None)


def trace_path(cell) -> Path:
    """Where `runner.run_cell` writes the cell's traced slice."""
    return Path(cell.root) / "build" / "portbench" / "trace" / f"{cell.name}.json"


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int, size: int) -> Spans:
    with open(path) as f:
        return Spans(json.load(f)["traceEvents"])


def read(rec) -> Spans | None:
    """The traced slice's spans, or None: no traced slice, no device op
    in it, or no `repro.*` range.  One parse serves every reader of a run."""
    if rec.trace is None or not rec.trace.device:
        return None
    path = trace_path(rec.cell)
    if not path.is_file():
        return None
    st = path.stat()
    spans = _load(str(path), st.st_mtime_ns, st.st_size)
    return spans if spans.ranges else None
