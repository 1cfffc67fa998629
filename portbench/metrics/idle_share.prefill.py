"""idle_share.prefill (%): 1 - (union of the device's kernel, copy and set
intervals) / the traced slice's wall time, both from the one trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
