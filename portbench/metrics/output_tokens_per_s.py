"""output_tokens_per_s (tokens/s): every token generated in the window (one
per session a step), over the window, which ends with a synchronize."""
from portbench.harness.stats import window_rate


def read(rec):
    w = rec.window
    return window_rate(w["tokens_out"], w["t0"], w["t1"])
