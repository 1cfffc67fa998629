"""The comparison that decides `correct` for a served model.

For each served greedy token, the gap by which its logit in the plain f32
reference lies below the reference's best at that position: 0 where the
program served the reference's argmax, small where rounding let a near-tie
go the other way.  The control (the reference computed in float8) is put
in the program's place: at exactly the positions the program is read, it
serves the token that it puts first, and that token's gap is read the same
way.  Logits are made in blocks of positions so that a long prompt's fit.
"""
from __future__ import annotations

import torch

BLOCK = 1024


def gaps(ref, conf, params, tokens, positions, served, control: bool = False) -> dict:
    """tokens (B, S) on the device; `served[b][i]` the token the program
    served after position `positions[i]` of row b.  -> {"served": widest
    gap of the served tokens, "control": widest gap of the control's
    picks at the same positions (with `control`)}."""
    x = ref.hidden(conf, params, tokens)[:, positions].flatten(0, 1)
    xc = ref.hidden(conf, params, tokens, control=True)[:, positions].flatten(0, 1) \
        if control else None
    want = [t for row in served for t in row]
    vocab = conf["vocab_size"]
    out = {"served": 0.0}
    if control:
        out["control"] = 0.0
    for i in range(0, len(want), BLOCK):
        lr = ref.logits(conf, params, x[i:i + BLOCK])
        best = lr.max(-1).values
        tok = torch.tensor(want[i:i + BLOCK], device=lr.device)
        ok = (tok >= 0) & (tok < vocab)
        gap = best - lr.gather(-1, tok.clamp(0, vocab - 1)[:, None])[:, 0]
        out["served"] = max(out["served"], torch.where(ok, gap, float("inf")).max().item())
        if control:
            pick = ref.logits(conf, params, xc[i:i + BLOCK], control=True).argmax(-1)
            out["control"] = max(out["control"],
                                 (best - lr.gather(-1, pick[:, None])[:, 0]).max().item())
        del lr
    return out
