"""flash_roofline (%): over the traced slice's flash-attention launches, the
sum of the least time each launch's shape allows (`roofline.flash_cost` at
the bf16 peak and the HBM bandwidth) over the sum of their device times.
Each batch's launches take its shape, in launch order; the count must match
the port's launch counter, else nothing is read."""
from portbench.harness.roofline import bound_s, flash_cost


def read(rec):
    shape = rec.reference.attention_shape(rec.conf)
    if rec.trace is None or shape is None:
        return None
    _, hq, hkv, dh = shape
    kernels = rec.trace.kernels("flash_")
    bounds = []
    for b in rec.slice["batches"]:
        f, n = flash_cost(b["B"], hq, hkv, b["S"], dh)
        bounds += [bound_s(f, n, rec.peaks["bf16_flops"], rec.peaks["hbm_bytes"])] \
            * b["launches"]["flash_attention"]
    if not kernels or len(kernels) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(e - s for s, e, _ in kernels)
