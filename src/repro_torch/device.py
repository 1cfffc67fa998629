"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent.

    Nothing falls back to the CPU: a caller that wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def synchronize(dev: torch.device):
    """Wait for the device's queued work; a no-op on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_memory(dev: torch.device) -> int | None:
    """The card's memory in bytes; None for the CPU (not checked)."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return None
