"""The public kernel API.

`flash_attention` is the kernel wrapper itself (one object, one launch
counter).  The JAX package's other wrappers, `rglru_scan` and `mamba_scan`,
and its per-example task bodies (`matmul_task`, `attention_task`) are ported
in later slices (ROADMAP.md).
"""
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["flash_attention"]
