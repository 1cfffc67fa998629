"""The table of peaks and the operations and bytes of the port's kernels.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at the
700 W limit).  The kernels' counts are copied from `chip_smoke.py`
(`bound`, `attended_pairs`, `time_flash`, `time_mamba`), so that a change
to the program cannot move this yardstick.  A launch's least time is the
larger of its operations over the peak rate and its bytes over the HBM
bandwidth, each input byte read once and each output byte written once.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks(kind: str | None) -> dict:
    """The peaks of the card named `kind`; the H100 SXM's for any other."""
    return PEAKS.get(kind or "", DEFAULT_PEAKS)


def bound_s(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time (s) a launch of `flops` operations moving `nbytes` can take."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def attended_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(row, col) pairs of an S x S attention that the mask leaves unmasked:
    col <= row if causal, col > row - window if window."""
    if causal and not window:
        return S * (S + 1) // 2
    return sum((r if causal else S - 1) - (max(0, r - window + 1) if window else 0) + 1
               for r in range(S))


def flash_cost(B: int, Hq: int, Hkv: int, S: int, D: int, *, causal=True, window=0,
               elem_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one flash launch on q (B, Hq, S, D) and k, v
    (B, Hkv, S, D): QK^T and PV over the attended pairs; q, k, v read and o
    written once."""
    flops = 4 * B * Hq * D * attended_pairs(S, causal, window)
    nbytes = elem_bytes * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    return flops, nbytes


def mamba_scan_cost(B: int, S: int, D: int, N: int, *, elem_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one selective-scan launch: per state element
    dt*A, exp, dBu, the state update (2) and y_t (2), per channel dt*u; u,
    dt and y in the input dtype, A (D, N) and the final state (B, D, N) in
    f32, Bm and Cm (B, S, N) in the input dtype."""
    n = B * S * D
    flops = 7 * n * N + n
    nbytes = 3 * n * elem_bytes + 4 * D * N + 4 * B * D * N + 2 * B * S * N * elem_bytes
    return flops, nbytes
