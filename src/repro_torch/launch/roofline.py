"""Three-term roofline of one step, per device, for a cluster of H100s.

The counterpart of the JAX package's `repro/launch/hlo_analysis.py`
(`CollectiveStats`, `roofline`); the numbers it reads come from
`op_cost.analyze` instead of XLA's cost analysis and HLO text.

Hardware model, from data sheets, not measured here:
  * H100 SXM 80GB at its 700 W limit: 989e12 bf16 dense FLOP/s and 3.35e12
    B/s of HBM3 (NVIDIA's H100 data sheet; the same figures
    `chip_smoke.py` bounds its kernels with);
  * the links: one per-GPU rate for the slowest link a 16-wide group
    crosses.  A 16-wide "model" (or "data") group spans two 8-GPU NVLink
    nodes, so its ring runs at the inter-node rate: 50e9 B/s per GPU, one
    NDR InfiniBand port at 400 Gb/s (NVIDIA DGX H100 data sheet: eight 400
    Gb/s ConnectX-7 ports, one per GPU).
Every term is thus a prediction for such a cluster, never a measurement.
"""
from __future__ import annotations

import dataclasses

HW = {
    "name": "H100 SXM 80GB, 700 W: 989e12 bf16 dense FLOP/s, 3.35e12 B/s HBM3; "
            "links 50e9 B/s per GPU (NDR InfiniBand, 400 Gb/s)",
    "peak_flops": 989e12,   # bf16 dense FLOP/s per GPU
    "hbm_bw": 3.35e12,      # bytes/s per GPU
    "link_bw": 50e9,        # bytes/s per GPU on the slowest link of a 16-wide ring
    "hbm_bytes": 80e9,      # device memory per GPU
}


@dataclasses.dataclass
class CollectiveStats:
    per_device_wire_bytes: float = 0.0
    by_kind: dict = dataclasses.field(default_factory=dict)
    count: int = 0


def roofline(cost: dict, coll: CollectiveStats, n_chips: int,
             model_flops: float | None = None) -> dict:
    """Three roofline terms in seconds (per step, per device)."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    compute_t = flops / HW["peak_flops"]
    memory_t = nbytes / HW["hbm_bw"]
    coll_t = coll.per_device_wire_bytes / HW["link_bw"]
    dominant = max(
        [("compute", compute_t), ("memory", memory_t), ("collective", coll_t)],
        key=lambda kv: kv[1])[0]
    out = {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "collective_bytes_per_device": coll.per_device_wire_bytes,
        "collective_ops": coll.by_kind,
        "compute_term_s": compute_t,
        "memory_term_s": memory_t,
        "collective_term_s": coll_t,
        "dominant": dominant,
        "bound_time_s": max(compute_t, memory_t, coll_t),
    }
    if model_flops is not None:
        out["model_flops_total"] = model_flops
        out["model_flops_per_device"] = model_flops / n_chips
        if flops > 0:
            out["useful_flops_ratio"] = (model_flops / n_chips) / flops
        out["mfu_bound"] = (model_flops / n_chips / HW["peak_flops"]) / \
            max(compute_t, memory_t, coll_t, 1e-30)
    return out
