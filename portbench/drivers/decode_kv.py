"""Kind `decode_kv`: greedy decode of many sessions whose attention caches
grow to take the tokens.

What `drivers/decode.py` does (imported, not copied: the prompts, the
joined caches, the step, the clock, the counts), with two differences:

* set-up grows the joined prefill caches by `grow` positions before the
  warm-up, with the port's own `repro_torch.serve.grow_caches`: the step
  the port's `serve.serve` takes between prefill and decode, and the one
  public function of the port that this driver calls, so that a cache is
  grown as the port grows it (the attention caches padded along their
  positions; recurrent states and conv tails left as they are);
* the window ends after `--seconds` or when the room is used up,
  whichever comes first, leaving `slice_steps` positions for the traced
  slice.  Its rate is its tokens over its own time, as in `decode`.

The traced slice first resets the family adapter's counters
(`reset_counters`), where it has them, so that what the port counts while
the profiler records is the slice's alone; the readers read them after.

Traffic keys: those of `decode`, and grow.  The check reads what
`decode`'s does, every token served to `sample_sessions` sessions drawn
from the seed against the reference's one pass over the prompt and the
served tokens, and gives each served token's gap (`compare.gaps`'s): their
widest, `max_logit_gap`, and their mean, `mean_logit_gap`, with the
control's two beside them.  A cell's limits file names the numbers it
judges.  The mean is for a model whose top-k router turns rounding into
discrete jumps (a near-tied expert chosen the other way moves every later
position a little): there the widest gap of bf16 and of the float8 control
lie less than 3x apart, their means far more.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.drivers import decode
from portbench.harness.compare import BLOCK
from portbench.harness.stats import derive

prompts, counts, release = decode.prompts, decode.counts, decode.release


def setup(ctx) -> dict:
    from repro_torch.serve import grow_caches
    t = ctx.traffic
    P, n, chunk, grow = t["prompt_length"], t["sessions"], t["prefill_sessions"], t["grow"]
    if grow < t["warm_steps"] + t["slice_steps"] + 1:
        raise ValueError(f"grow {grow} leaves no room for the warm-up, a window step and the "
                         f"traced slice ({t['warm_steps']} + 1 + {t['slice_steps']})")
    toks = prompts(ctx)
    firsts, parts = [], []
    for c0 in range(0, n, chunk):
        first, caches = ctx.program.prefill(ctx.params, toks[c0:c0 + chunk])
        firsts.append(first)
        parts.append(caches)
    caches = decode._cat_caches(parts)
    del parts
    state = {"caches": grow_caches(caches, P, P + grow), "pos": P, "end": P + grow,
             "tokens": [torch.cat(firsts).to(torch.int32)]}
    del caches
    for _ in range(t["warm_steps"]):
        decode._step(ctx, state)
    ctx.sync()
    return state


def window(ctx, state, seconds: float) -> dict:
    """Decode steps until `seconds` have passed or only the traced slice's
    room is left."""
    last = state["end"] - ctx.traffic["slice_steps"]
    clock = decode._Clock(ctx.device)
    first = len(state["tokens"])
    ctx.sync()
    t0 = time.perf_counter()
    clock.mark()
    while time.perf_counter() - t0 < seconds and state["pos"] < last:
        decode._step(ctx, state)
        clock.mark()
    ctx.sync()
    t1 = time.perf_counter()
    steps = len(state["tokens"]) - first
    return {"t0": t0, "t1": t1, "steps": steps, "sessions": ctx.traffic["sessions"],
            "tokens_out": steps * ctx.traffic["sessions"], "itl_ms": clock.gaps_ms()}


def traced_slice(ctx, state) -> dict:
    getattr(ctx.cell.adapter(), "reset_counters", lambda: None)()
    return decode.traced_slice(ctx, state)


def token_gaps(ref, conf, params, tokens, positions, served, control: bool = False):
    """`compare.gaps`, each token's gap kept: tokens (B, S); `served[b][i]`
    the token served after position `positions[i]` of row b -> (the gap of
    every served token, row-major (inf for an id outside the vocabulary),
    and with `control` the gap of the control's pick at each)."""
    x = ref.hidden(conf, params, tokens)[:, positions].flatten(0, 1)
    xc = ref.hidden(conf, params, tokens, control=True)[:, positions].flatten(0, 1) \
        if control else None
    want = [t for row in served for t in row]
    vocab = conf["vocab_size"]
    mine, theirs = [], []
    for i in range(0, len(want), BLOCK):
        lr = ref.logits(conf, params, x[i:i + BLOCK])
        best = lr.max(-1).values
        tok = torch.tensor(want[i:i + BLOCK], device=lr.device)
        ok = (tok >= 0) & (tok < vocab)
        gap = best - lr.gather(-1, tok.clamp(0, vocab - 1)[:, None])[:, 0]
        mine.append(torch.where(ok, gap, float("inf")))
        if control:
            pick = ref.logits(conf, params, xc[i:i + BLOCK], control=True).argmax(-1)
            theirs.append(best - lr.gather(-1, pick[:, None])[:, 0])
        del lr
    return torch.cat(mine), (torch.cat(theirs) if control else None)


def check(ctx, state, w: dict) -> dict:
    """`max_logit_gap` and `mean_logit_gap` of every served token of the
    sampled sessions (`decode.check`'s sample and positions); with
    `ctx.control`, the control's (`control_<name>`)."""
    P = ctx.traffic["prompt_length"]
    served = torch.stack(state["tokens"], 1)                  # (sessions, tokens served)
    rng = random.Random(derive(ctx.seed, "sample"))
    picks = rng.sample(range(ctx.traffic["sessions"]), ctx.limits["sample_sessions"])
    seq = torch.cat([prompts(ctx)[picks], served[picks, :-1].to(torch.int64)], 1)
    pos = list(range(P - 1, P - 1 + served.shape[1]))
    gaps, ctrl = token_gaps(ctx.reference, ctx.conf, ctx.params, seq, pos,
                            served[picks].tolist(), control=ctx.control)
    out = {"max_logit_gap": gaps.max().item(), "mean_logit_gap": gaps.mean().item()}
    if ctx.control:
        out["control_max_logit_gap"] = ctrl.max().item()
        out["control_mean_logit_gap"] = ctrl.mean().item()
    return out
