"""Prefill and greedy serve steps (built per config).

`make_train_step` comes with the training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch["tokens"])

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, caches, tokens, pos_t) ->
    (next_tokens, caches), the caches updated in place."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos_t):
        logits, new_caches = T.decode_step(cfg, params, caches, tokens, pos_t)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, new_caches

    return serve_step
