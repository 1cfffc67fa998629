"""moe_experts_roofline.decode (%): over the traced slice's MoE layer
calls, the sum of the least time each call's expert products allow, over
the device time of the ops launched inside the port's `repro.moe.experts`
spans (the union of their intervals, `harness/spans.py`).

A call's least time is the larger of its operations over the bf16 peak
and its bytes over the HBM bandwidth (`harness/roofline.py`), counted by
the reference from the assignments each held expert got in that call
(`reference/<family>.py::expert_cost`: each expert with one or more
assignments reads its three matrices once, each assignment's row is read
and written, 6 d eff operations an assignment).  The assignments are the
port's per-expert counters of the slice, read through the family adapter
(`counters`).  The same work is counted whatever computes the experts.
Nothing where the program opens no such span or counts nothing."""
from portbench.harness import spans
from portbench.harness.roofline import bound_s


def read(rec):
    cost = getattr(rec.reference, "expert_cost", None)
    read_counters = getattr(rec.cell.adapter(), "counters", None)
    sp = spans.read(rec)
    if cost is None or read_counters is None or sp is None or "repro.moe.experts" not in sp.ranges:
        return None
    layers = read_counters() or []
    calls = [c for layer in layers for c in layer["calls"]]
    device_s = sp.device_s("repro.moe.experts")
    if not calls or device_s <= 0:
        return None
    least = sum(bound_s(*cost(rec.conf, c), rec.peaks["bf16_flops"], rec.peaks["hbm_bytes"])
                for c in calls)
    return 100.0 * least / device_s
