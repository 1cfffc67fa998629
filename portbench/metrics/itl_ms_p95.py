"""itl_ms_p95 (ms): the 95th percentile of the gaps between consecutive
decode steps' completions in the window, from CUDA events recorded after
each step (no synchronize a step)."""
from portbench.harness.stats import percentile


def read(rec):
    gaps = rec.window.get("itl_ms") or []
    return percentile(gaps, 95) if gaps else None
