"""The traced slice: `torch.profiler` over a bounded steady stretch of the
run, written as a Chrome trace under the checkout and read back.

The profiler records the host's operators and, on a card, the device's
activity and the CUDA calls (CUPTI).  Tracing costs the host time at every
launch, so a slice of a launch-bound step runs slower than the untraced
window (a decode step of `falcon-mamba-7b.decode_256`: ~135 ms traced, 82
ms untraced, with or without the host operators): its idle share is that
of the traced slice.  Device activity is every kernel, copy and set on the card.  The
slice is bounded on the device by two marker kernels (`torch.cuda._sleep`'s
`spin_kernel`), one launched before the traced work and one after it,
followed by a synchronize: its wall time and the device intervals come
from one trace and one clock.  Without a card (the tests) the slice is the
`portbench.slice` range.
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path

from portbench.harness.stats import gaps, union_length

SLICE = "portbench.slice"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


MARKER = "spin_kernel"
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def _span(e):
    return e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6


class Trace:
    """What the metrics read from one traced slice (times in seconds)."""

    def __init__(self, events: list[dict]):
        events = [e for e in events if "dur" in e and "ts" in e]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and e.get("name", "").startswith(LAUNCH_PREFIXES)]
        marks = sorted((e for e in dev if MARKER in e.get("name", "")), key=lambda e: e["ts"])
        if len(marks) >= 2:
            self.t0, self.t1 = _span(marks[0])[0], _span(marks[-1])[1]
            # the launches between the two markers' own launches
            by_corr = {e.get("args", {}).get("correlation"): e for e in calls}
            h0, h1 = (by_corr.get(m.get("args", {}).get("correlation")) for m in (marks[0], marks[-1]))
            dev = [e for e in dev if MARKER not in e.get("name", "")]
            if h0 is not None and h1 is not None:
                self.launches = sum(1 for e in calls if h0["ts"] < e["ts"] < h1["ts"])
            else:
                self.launches = sum(1 for e in dev if e.get("cat") == "kernel"
                                    and self.t0 <= _span(e)[0] <= self.t1)
        else:
            ann = [e for e in events if e.get("name") == SLICE]
            if not ann:
                raise ValueError(f"the trace holds neither {MARKER!r} markers nor a {SLICE!r} range")
            self.t0, self.t1 = _span(max(ann, key=lambda e: e["dur"]))
            self.launches = sum(1 for e in calls if self.t0 <= e["ts"] * 1e-6 <= self.t1)
        self.device = sorted((*_span(e), e["name"]) for e in dev)
        self.host_ops = sorted((*_span(e), e["name"]) for e in events
                               if e.get("cat") in HOST_CATS and e.get("name") != SLICE)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        """Seconds inside the slice in which some device operation ran."""
        return union_length([(s, e) for s, e, _ in self.device], self.t0, self.t1)

    def kernels(self, substring: str):
        """(start, end, name) of the slice's kernels whose name holds
        `substring`, in launch order (one stream: device order)."""
        return [k for k in self.device if substring in k[2] and self.t0 <= k[0] <= self.t1]

    def device_ops(self, top: int = 10):
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for s, e, n in self.device:
            if self.t0 <= s <= self.t1:
                by[n] = by.get(n, 0.0) + (min(e, self.t1) - s)
        return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[host op, seconds] of the longest idle gaps of the device, each
        named by the innermost host operation running at its midpoint."""
        out = []
        for s, e in gaps([(a, b) for a, b, _ in self.device], self.t0, self.t1)[:top]:
            mid, name, best = (s + e) / 2, "host: between CUDA calls", None
            for hs, he, hn in self.host_ops:
                if hs > mid:
                    break
                if he >= mid and (best is None or he - hs < best):
                    name, best = hn, he - hs
            out.append([name[:160], e - s])
        return out


@contextlib.contextmanager
def traced(path: Path, sync):
    """Profile the body inside one `portbench.slice` range, between two
    marker kernels on a card; the body's work is synchronized before the
    range closes.  The Chrome trace is written to `path` (one fixed file,
    overwritten), read back, and left in `holder["trace"]`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    holder = {}
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            if cuda:
                torch.cuda._sleep(1000)
            yield holder
            if cuda:
                torch.cuda._sleep(1000)
            sync()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        holder["trace"] = Trace(json.load(f)["traceEvents"])
