"""Kind `decode`: greedy decode of many sessions at once.

Set-up prefills `sessions` prompts of `prompt_length` tokens (drawn on the
device from the seed), `prefill_sessions` at a time, joins their caches
along the batch and warms the decode step (`warm_steps` steps, their
tokens served like any other).  The window then runs decode steps, each
emitting one token per session, until `--seconds` have passed, and ends
with a synchronize.  A CUDA event recorded after each step gives the gaps
between steps' completions; the tokens stay on the device (no host
round trip a step).

Traffic keys: kind, sessions, prompt_length, prefill_sessions, warm_steps,
slice_steps.  A model whose cache has to grow to take the tokens (a kv
cache) has no mix of this kind yet.  The check (`limits/<cell>.json`, "sample_sessions"): that
many sessions drawn from the seed, every token they were served.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.harness.compare import gaps
from portbench.harness.stats import derive


def prompts(ctx):
    t = ctx.traffic
    g = torch.Generator(device=ctx.device)
    g.manual_seed(derive(ctx.seed, "prompt"))
    return torch.randint(0, ctx.vocab, (t["sessions"], t["prompt_length"]), generator=g,
                         device=ctx.device)


def _cat_caches(parts):
    """Join per-chunk caches along the batch (dim 1 of each stacked leaf)."""
    if isinstance(parts[0], dict):
        return {k: _cat_caches([p[k] for p in parts]) for k in parts[0]}
    if isinstance(parts[0], list):
        return [_cat_caches([p[i] for p in parts]) for i in range(len(parts[0]))]
    return torch.cat(parts, dim=1)


class _Clock:
    """Completion times of steps: CUDA events on a card, the host clock
    after a synchronize elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def setup(ctx) -> dict:
    t = ctx.traffic
    P, n, chunk = t["prompt_length"], t["sessions"], t["prefill_sessions"]
    toks = prompts(ctx)
    firsts, parts = [], []
    for c0 in range(0, n, chunk):
        first, caches = ctx.program.prefill(ctx.params, toks[c0:c0 + chunk])
        firsts.append(first)
        parts.append(caches)
    caches = _cat_caches(parts)
    del parts
    state = {"caches": caches, "pos": P, "tokens": [torch.cat(firsts).to(torch.int32)]}
    for _ in range(t["warm_steps"]):
        _step(ctx, state)
    ctx.sync()
    return state


def _step(ctx, state):
    tok = state["tokens"][-1][:, None]
    nxt = ctx.program.step(ctx.params, state["caches"], tok, state["pos"])
    state["pos"] += 1
    state["tokens"].append(nxt[:, 0])


def window(ctx, state, seconds: float) -> dict:
    clock = _Clock(ctx.device)
    first = len(state["tokens"])
    ctx.sync()
    t0 = time.perf_counter()
    clock.mark()
    while time.perf_counter() - t0 < seconds:
        _step(ctx, state)
        clock.mark()
    ctx.sync()
    t1 = time.perf_counter()
    steps = len(state["tokens"]) - first
    return {"t0": t0, "t1": t1, "steps": steps, "sessions": ctx.traffic["sessions"],
            "tokens_out": steps * ctx.traffic["sessions"], "itl_ms": clock.gaps_ms()}


def traced_slice(ctx, state) -> dict:
    n = ctx.traffic["slice_steps"]
    for _ in range(n):
        _step(ctx, state)
    return {"steps": n}


def release(ctx, state):
    state.pop("caches", None)


def counts(ctx, w: dict) -> tuple[int, int]:
    """(sessions attempted, sessions failed: a served id outside the vocab)."""
    return w["sessions"], 0


def check(ctx, state, w: dict) -> dict:
    """The widest gap of every served token of the sampled sessions below
    the reference's best at its position (`compare.gaps`), the reference
    run once over each prompt and its served tokens; with `ctx.control`,
    also the control's first pick at each of those positions."""
    P = ctx.traffic["prompt_length"]
    served = torch.stack(state["tokens"], 1)                  # (sessions, tokens served)
    rng = random.Random(derive(ctx.seed, "sample"))
    picks = rng.sample(range(ctx.traffic["sessions"]), ctx.limits["sample_sessions"])
    seq = torch.cat([prompts(ctx)[picks], served[picks, :-1].to(torch.int64)], 1)
    pos = list(range(P - 1, P - 1 + served.shape[1]))
    g = gaps(ctx.reference, ctx.conf, ctx.params, seq, pos, served[picks].tolist(),
             control=ctx.control)
    out = {"max_logit_gap": g["served"]}
    if ctx.control:
        out["control_max_logit_gap"] = g["control"]
    return out
