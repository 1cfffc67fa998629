"""mamba_state_ms_per_step.decode (ms): device time of the ops the port
launched inside its `repro.mamba.state` spans (a Mamba layer's decode
state update: dt, exp(dt A), the new state, its copy into the cache and y),
per decode step of the traced slice: the union of their intervals,
clipped to the slice (`harness/spans.py`).  Nothing where the program
opens no such span."""
from portbench.harness import spans


def read(rec):
    sp = spans.read(rec)
    if sp is None or "repro.mamba.state" not in sp.ranges or not rec.slice:
        return None
    return 1e3 * sp.device_s("repro.mamba.state") / rec.slice["steps"]
