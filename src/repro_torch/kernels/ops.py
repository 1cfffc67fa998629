"""The public kernel API.

Each name is the kernel wrapper itself (one object, one launch counter):
`flash_attention`, `mamba_scan` and `rglru_scan`.  The JAX package's
per-example task bodies (`matmul_task`, `attention_task`) are ported with
the device tier (ROADMAP.md).
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.rglru_scan import rglru_scan

__all__ = ["flash_attention", "mamba_scan", "rglru_scan"]
