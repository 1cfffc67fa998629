"""mamba_scan_roofline (%): over the traced slice's selective-scan launches,
the sum of the least time each launch's shape allows
(`roofline.mamba_scan_cost` at the f32 peak of the CUDA cores and the HBM
bandwidth) over the sum of their device times.  Each batch's launches
take its shape, in launch order; the count must match the port's launch
counter, else nothing is read."""
from portbench.harness.roofline import bound_s, mamba_scan_cost


def read(rec):
    shape = getattr(rec.reference, "scan_shape", lambda conf: None)(rec.conf)
    if rec.trace is None or shape is None:
        return None
    _, din, n_state = shape
    kernels = rec.trace.kernels("mamba_scan_kernel")
    bounds = []
    for b in rec.slice["batches"]:
        f, n = mamba_scan_cost(b["B"], b["S"], din, n_state)
        bounds += [bound_s(f, n, rec.peaks["f32_flops"], rec.peaks["hbm_bytes"])] \
            * b["launches"]["mamba_scan"]
    if not kernels or len(kernels) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(e - s for s, e, _ in kernels)
