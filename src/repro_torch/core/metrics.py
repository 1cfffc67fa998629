"""Bounded streaming metrics for million-task runs (DESIGN.md §4).

The seed implementation appended one log entry per task to plain lists
(`queue_len_log`, `alloc_log`, per-executor `task_log`), so a 10^6-task run
grew tens of millions of tuples.  `StreamStat` replaces those with O(1)
rolling counters (count / total / peak / last) plus a fixed-size,
deterministic reservoir: observations are kept every `stride`-th sample and
when the reservoir fills, every other kept sample is dropped and the stride
doubles.  Memory is bounded by `cap` regardless of run length, and the
decimation is reproducible under `SimClock` (no RNG).
"""
from __future__ import annotations

import math


def percentile_of(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence (0 when
    empty).  Deterministic and allocation-free — shared by `StreamStat`
    reservoirs and the observability layer's span percentiles."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    idx = min(n - 1, max(0, math.ceil(q * n) - 1))
    v = sorted_vals[idx]
    # reservoir entries are (t, v) pairs; bare series are floats
    return v[1] if isinstance(v, tuple) else v


class StreamStat:
    """Rolling summary of a (time, value) series with a bounded sample."""

    __slots__ = ("cap", "count", "total", "peak", "low", "last", "sample",
                 "_stride", "_skip")

    def __init__(self, cap: int = 512):
        if cap < 2:
            raise ValueError("cap must be >= 2")
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.peak: float | None = None
        self.low: float | None = None
        self.last: float | None = None
        self.sample: list[tuple[float, float]] = []
        self._stride = 1
        self._skip = 0

    def observe(self, t: float, v: float) -> None:
        self.count += 1
        self.total += v
        if self.peak is None or v > self.peak:
            self.peak = v
        if self.low is None or v < self.low:
            self.low = v
        self.last = v
        if self._skip:
            self._skip -= 1
            return
        self.sample.append((t, v))
        if len(self.sample) >= self.cap:
            # decimate: drop every other sample, keeping the first so the
            # series origin stays anchored
            del self.sample[1::2]
            self._stride *= 2
        self._skip = self._stride - 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- cross-process merge (DESIGN.md §14) ----------------------------
    def snapshot(self) -> dict:
        """Full picklable/JSON-able state — lossless up to the reservoir,
        unlike `summary()`.  Ship it across a process boundary and rebuild
        with `from_snapshot`, or fold it into an aggregate with `merge`."""
        return {
            "cap": self.cap,
            "count": self.count,
            "total": self.total,
            "peak": self.peak,
            "min": self.low,
            "last": self.last,
            "sample": list(self.sample),
            "stride": self._stride,
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "StreamStat":
        """Rebuild a stat from `snapshot()` output (e.g. one shipped back
        by a federation shard process)."""
        st = cls(cap=snap["cap"])
        st.count = snap["count"]
        st.total = snap["total"]
        st.peak = snap["peak"]
        st.low = snap["min"]
        st.last = snap["last"]
        st.sample = [tuple(s) for s in snap["sample"]]
        st._stride = snap["stride"]
        return st

    def merge(self, other: "StreamStat") -> "StreamStat":
        """Fold another stat into this one (cross-process aggregation):
        count/total/peak/min are exact; the merged reservoir is the
        time-sorted union of both samples, decimated back under `cap` by
        the same drop-every-other scheme `observe` uses, so percentile
        estimates stay within reservoir tolerance.  `last` takes the
        merge argument's value when it has one (the caller folds shards
        into an aggregate, so "most recently merged" is the useful
        reading).  Returns self."""
        if other.count == 0:
            return self
        self.count += other.count
        self.total += other.total
        if self.peak is None or (other.peak is not None
                                 and other.peak > self.peak):
            self.peak = other.peak
        if self.low is None or (other.low is not None
                                and other.low < self.low):
            self.low = other.low
        if other.last is not None:
            self.last = other.last
        merged = sorted(self.sample + list(other.sample))
        stride = max(self._stride, other._stride)
        while len(merged) >= self.cap:
            del merged[1::2]
            stride *= 2
        self.sample = merged
        self._stride = stride
        self._skip = 0
        return self

    def percentile(self, q: float) -> float:
        """Streaming percentile estimated from the reservoir (exact until
        the first decimation, q-quantile of a deterministic stride
        thinning after).  `q` in [0, 1]."""
        return percentile_of(sorted(v for _, v in self.sample), q)

    def summary(self) -> dict:
        vals = sorted(v for _, v in self.sample)
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.mean(),
            "peak": self.peak,
            "min": self.low,
            "last": self.last,
            "p50": percentile_of(vals, 0.50),
            "p95": percentile_of(vals, 0.95),
            "p99": percentile_of(vals, 0.99),
            "samples_kept": len(self.sample),
            "sample_stride": self._stride,
        }

    def __repr__(self):
        return (f"<StreamStat n={self.count} mean={self.mean():.3g} "
                f"peak={self.peak} kept={len(self.sample)}>")
