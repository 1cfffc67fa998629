"""Kind `prefill`: closed-loop prefill-only requests (one new token each).

One client sends one batch at a time and the next when the previous
batch's first tokens are on the host.  A cycle holds one batch of each
prompt length in `prompt_lengths`, each batch `tokens_per_batch` tokens
(B = tokens_per_batch / length); the seed sets the order of the batches in
each cycle and every prompt's token ids, so every seed sends the same sizes.
A request is issued when its batch starts and ends when its first token's
id is on the host.  The window runs whole cycles and closes at the first
cycle's end past `--seconds`.

Traffic keys: kind, prompt_lengths, tokens_per_batch.  The check's sample
(`limits/<cell>.json`, "sample_lengths"): for each listed length, every
request of one finished batch of that length, the batch drawn from the
seed.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.harness.compare import gaps
from portbench.harness.stats import derive


def cycle_order(traffic: dict, seed: int, cycle: int) -> list[int]:
    """The prompt lengths of one cycle's batches, in the order sent."""
    order = list(traffic["prompt_lengths"])
    random.Random(derive(seed, "order", cycle)).shuffle(order)
    return order


def batch_shape(traffic: dict, S: int) -> tuple[int, int]:
    B, rem = divmod(traffic["tokens_per_batch"], S)
    if rem or not B:
        raise ValueError(f"tokens_per_batch {traffic['tokens_per_batch']} is no multiple of {S}")
    return B, S


def prompts(ctx, tag, B: int, S: int):
    """The token ids of one batch, drawn on the device from the seed."""
    g = torch.Generator(device=ctx.device)
    g.manual_seed(derive(ctx.seed, "prompt", *tag))
    return torch.randint(0, ctx.vocab, (B, S), generator=g, device=ctx.device)


def _send(ctx, tag, S, out):
    B, S = batch_shape(ctx.traffic, S)
    toks = prompts(ctx, tag, B, S)
    before = ctx.program.launches()
    t_issue = time.perf_counter()
    first, caches = ctx.program.prefill(ctx.params, toks)
    served = first.tolist()                     # on the host: the request ends
    t_done = time.perf_counter()
    del caches
    after = ctx.program.launches()
    out.append({"tag": tag, "B": B, "S": S, "t_issue": t_issue, "t_done": t_done,
                "served": served, "launches": {k: after[k] - before[k] for k in after}})


def setup(ctx) -> dict:
    """Warm every prompt length of the mix once (a stream of its own)."""
    warm = []
    for S in ctx.traffic["prompt_lengths"]:
        _send(ctx, ("warm", S), S, warm)
    return {"cycle": 0}


def window(ctx, state, seconds: float) -> dict:
    batches = []
    t0 = time.perf_counter()
    while True:
        c = state["cycle"]
        for j, S in enumerate(cycle_order(ctx.traffic, ctx.seed, c)):
            _send(ctx, (c, j), S, batches)
        state["cycle"] += 1
        if batches[-1]["t_done"] - t0 >= seconds:
            break
    return {"t0": t0, "t1": batches[-1]["t_done"], "batches": batches}


def traced_slice(ctx, state) -> dict:
    """One more whole cycle."""
    batches = []
    c = state["cycle"]
    for j, S in enumerate(cycle_order(ctx.traffic, ctx.seed, c)):
        _send(ctx, (c, j), S, batches)
    state["cycle"] += 1
    return {"batches": batches}


def release(ctx, state):
    pass


def counts(ctx, w: dict) -> tuple[int, int]:
    """(requests attempted, requests failed: a served id outside the vocab)."""
    served = [t for b in w["batches"] for t in b["served"]]
    return len(served), sum(1 for t in served if not 0 <= t < ctx.vocab)


def sample(ctx, w: dict) -> list[dict]:
    """The batches the check reads, every row of each: one finished batch
    of each length in the cell's `sample_lengths`, drawn from the seed."""
    rng = random.Random(derive(ctx.seed, "sample"))
    picks = []
    for S in ctx.limits["sample_lengths"]:
        cands = [b for b in w["batches"] if b["S"] == S]
        if not cands:
            raise RuntimeError(f"no finished batch of length {S} to check")
        picks.append(rng.choice(cands))
    return picks


def check(ctx, state, w: dict) -> dict:
    """The widest gap of a served first token below the reference's best,
    over the sample (`compare.gaps`); with `ctx.control`, also the
    control's, read at the same positions."""
    served, ctl = [], []
    for b in sample(ctx, w):
        toks = prompts(ctx, b["tag"], b["B"], b["S"])
        g = gaps(ctx.reference, ctx.conf, ctx.params, toks, [b["S"] - 1],
                 [[t] for t in b["served"]], control=ctx.control)
        served.append(g["served"])
        ctl.append(g.get("control"))
    out = {"max_logit_gap": max(served)}
    if ctx.control:
        out["control_max_logit_gap"] = max(ctl)
    return out
