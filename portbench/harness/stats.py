"""Arithmetic the metrics share: sub-seeds, percentiles, window rates and
the union of device intervals.  Pure Python; no device and no program."""
from __future__ import annotations

import hashlib
import math


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (`tags` name the use):
    any whole `seed`, negative or past 64 bits included."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all `values`, linear between the two
    nearest ranks (numpy's default), over every value, not over medians of
    chunks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(count: float, t0: float, t1: float) -> float:
    """`count` over the window [t0, t1] (seconds): all the work and all the
    time of the window."""
    if t1 <= t0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    return count / (t1 - t0)


def union_length(intervals, lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of (start, end) intervals, each clipped to
    [lo, hi] where given: overlapping intervals (kernels on two streams, a
    copy beside a kernel) count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle gaps (start, end) inside [lo, hi] that no interval covers,
    longest first."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])
