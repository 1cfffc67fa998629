"""moe_ms_per_step.decode (ms): device time of the ops the port launched
inside its `repro.moe` spans (an MoE layer: its norm, router, top-k, the
sort by expert, the expert products and the combine), per decode step of
the traced slice: the union of their intervals, clipped to the slice
(`harness/spans.py`).  Nothing where the program opens no such span."""
from portbench.harness import spans


def read(rec):
    sp = spans.read(rec)
    if sp is None or "repro.moe" not in sp.ranges or not rec.slice:
        return None
    return 1e3 * sp.device_s("repro.moe") / rec.slice["steps"]
