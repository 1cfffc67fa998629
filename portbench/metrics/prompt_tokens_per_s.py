"""prompt_tokens_per_s (tokens/s): every prompt token whose request's first
token reached the host inside the window, over the window (its first
batch's issue to its last batch's first tokens on the host)."""
from portbench.harness.stats import window_rate


def read(rec):
    w = rec.window
    return window_rate(sum(b["B"] * b["S"] for b in w["batches"]), w["t0"], w["t1"])
