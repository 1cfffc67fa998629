"""The system under test: the port's public entry points, and nothing else
of it, as the drivers call them.

`repro_torch` is imported here and in the family adapters only.  Faults
(`fault=`) exist for the benchmark's own tests: they break the timed path
underneath the harness so that the check must come out false.
"""
from __future__ import annotations

import sys
from pathlib import Path

FAULTS = ("state_unchanged", "half_batch", "token_altered")


def import_port():
    src = Path(__file__).resolve().parents[2] / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401


class Program:
    """The port's prefill and greedy serve steps for one configuration."""

    def __init__(self, cfg, fault: str | None = None):
        import_port()
        from repro_torch.train.steps import make_prefill_step, make_serve_step
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
        self.cfg, self.fault = cfg, fault
        self._prefill = make_prefill_step(cfg)
        self._serve = make_serve_step(cfg)

    def prefill(self, params, tokens):
        """-> (first served tokens (B,) on the device, caches)."""
        import torch
        if self.fault == "half_batch":
            # the second half of the batch is left out; its rows are answered
            # with the first half's tokens, every id in the vocabulary
            B = tokens.shape[0]
            half = max(1, B // 2)
            logits, caches = self._prefill(params, {"tokens": tokens[:half]})
            first = torch.argmax(logits[:, -1], dim=-1)
            return torch.cat([first, first[:B - half]]), caches
        logits, caches = self._prefill(params, {"tokens": tokens})
        first = torch.argmax(logits[:, -1], dim=-1)
        if self.fault == "token_altered":
            first = (first + 1) % self.cfg.vocab
        return first, caches

    def step(self, params, caches, tokens, pos: int):
        """One greedy decode step: tokens (B, 1) int32 -> next (B, 1); the
        caches are updated in place."""
        import torch
        if self.fault == "state_unchanged":
            scratch = [_clone(g) for g in caches]
            nxt, _ = self._serve(params, scratch, tokens, pos)
            return nxt
        nxt, _ = self._serve(params, caches, tokens, pos)
        if self.fault == "token_altered":
            nxt = ((nxt + 1) % self.cfg.vocab).to(torch.int32)
        return nxt

    @staticmethod
    def launches() -> dict:
        """The port's kernel launch counters."""
        from repro_torch.kernels import flash_attention, mamba_scan
        return {"flash_attention": flash_attention.flash_attention.launches,
                "mamba_scan": mamba_scan.mamba_scan.launches}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()
