"""device_ms_per_step.decode (ms): the seconds in which some device
operation ran (the union of the kernel, copy and set intervals) in the
traced slice, per decode step of the slice.  Tracing slows the host's
launches, not the device's work, so this reads the same traced or not;
the traced slice's idle share would read the tracer's own cost."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or not rec.slice:
        return None
    return 1e3 * t.busy_s / rec.slice["steps"]
