"""AdamW with global-norm clipping and a warmup-cosine schedule.

The port of the JAX package's `repro/optim/adamw.py`, on trees of tensors
(nested dicts and lists, leaves in `tree_leaves` order).  The numbers follow
the reference's f32 arithmetic: the schedule, `t = step + 1` and the bias
corrections are f32 scalars; the moments are f32; each leaf's update is
computed in f32 and cast back to the leaf's dtype.  `update` writes the new
parameters and moments in place and returns them.  Plain tensor ops: the
reference has no kernel here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import add_whole
from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    microbatches: int = 1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(hp: Hyper, step: int) -> torch.Tensor:
    """The learning rate at `step`, an f32 scalar on the CPU."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(1, hp.warmup), max=1.0)
    prog = torch.clamp((step - hp.warmup) / max(1, hp.total_steps - hp.warmup), 0, 1)
    cos = hp.min_lr_frac + (1 - hp.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return hp.lr * warm * cos


def init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(add_whole(*(torch.sum(torch.square(t.float())) for t in tree_leaves(tree))))


def clip_by_global_norm(grads, max_norm):
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def update(grads, state, params, step: int, hp: Hyper):
    """One AdamW step: `params`, `state["m"]` and `state["v"]` are updated
    in place; returns (params, state)."""
    lr = schedule(hp, step).item()
    b1, b2 = hp.b1, hp.b2
    t = _f32(step) + 1.0
    bc1 = (1.0 - torch.pow(_f32(b1), t)).item()
    bc2 = (1.0 - torch.pow(_f32(b2), t)).item()
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state["m"]), tree_leaves(state["v"]))
    for p, g, m, v in leaves:
        g = g.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        step_p = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
        pf = p.float()
        p.copy_((pf - lr * (step_p + hp.weight_decay * pf)).to(p.dtype))
    return params, state
