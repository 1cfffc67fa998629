"""launches_per_step.decode (launches): kernel launches (`cudaLaunch*` and
`cuLaunch*` calls) in the traced slice, per decode step of the slice."""


def read(rec):
    if rec.trace is None or not rec.slice or not rec.trace.launches:
        return None
    return rec.trace.launches / rec.slice["steps"]
