"""ttft_ms_p95 (ms): the 95th percentile, over every request finished in the
window, of the time from its batch's issue to its first token's id on the
host (closed loop, one client)."""
from portbench.harness.stats import percentile


def read(rec):
    ttft = [(b["t_done"] - b["t_issue"]) * 1e3 for b in rec.window["batches"] for _ in range(b["B"])]
    return percentile(ttft, 95)
