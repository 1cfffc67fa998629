"""prefill_mfu (%): model FLOPs of the prompts prefilled in the window
(`reference/<family>.py::prefill_flops`), over the window's time, over the
card's bf16 peak (989 TFLOP/s for an H100 SXM, `harness/roofline.py`)."""


def read(rec):
    w = rec.window
    flops = sum(rec.reference.prefill_flops(rec.conf, b["B"], b["S"]) for b in w["batches"])
    return 100.0 * flops / (w["t1"] - w["t0"]) / rec.peaks["bf16_flops"]
