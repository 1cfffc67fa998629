"""Mixture-of-experts FFN (DeepSeek-V2 / Granite style).

The counterpart of the JAX package's `repro/models/moe.py`, in its order of
operations: per group of `group_size` tokens, an f32 router, top-k gates
renormalized by their sum, the Switch balance loss, capacity slots in
k-slot-major priority (every token's first choice before any token's
second), assignments past the capacity dropped (they add nothing and the
kept gates are not renormalized again), the experts' GLU over the filled
slots, and the K-way weighted gather back.  Shared experts are an
always-on dense GLU branch.

Two dispatch modes, as in the reference (`MoEConfig.dispatch`): "scatter"
adds the tokens into the expert buffer with `index_add_`; "index" scatters
only the int32 slot -> token map and gathers the tokens.  Both give the
same buffer.  The buffer is laid out (E, B, c, d) rather than the
reference's (B, E, c, d), so that each expert's slots of the whole batch
are one contiguous (B * c, d) matrix and the expert products are three
batched GEMMs with no permuting copy; it holds the same rows.

Under the dry run's rules the slot count, the dispatch and the combine run
on each rank's own batch rows (`per_shard`; capacity is per sequence
group, so no rank needs another's), as the reference's per-row vmap does,
and the router's top-k and its renormalization run on each rank's own rows
(`per_row`), forward and backward.
The reference's two sharding annotations of the buffer sit at the same
points (`EXPERT_ROWS`), its dims in this layout's order: the experts dim
takes the data axis (expert-parallel, reached by an all-to-all) where it
divides, else the batch does; on the multi-pod mesh the batch keeps the
pod axis beside expert-parallel data (`_expert_rows`).  Elsewhere all of
this is the plain code.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import active_rules, add_partial, per_row, per_shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDesc, axis_size, placements

EXPERT_ROWS = ("experts", "batch", None, None)   # the buffer, (E, B, c, d)
ROWS = ("batch", None, None)                      # per batch row: (B, t, .) or (B, K, t)


def moe_descs(cfg: ModelConfig):
    m = cfg.moe
    d, E, eff = cfg.d_model, m.n_experts, m.expert_ff
    descs = {
        "norm": L.norm_descs(cfg),
        # the router is read in f32, so it is stored in f32 in any compute dtype
        "router": ParamDesc((d, E), ("embed", "experts"), f32=True),
        "w1": ParamDesc((E, d, eff), ("experts", "embed", "expert_ff")),
        "w3": ParamDesc((E, d, eff), ("experts", "embed", "expert_ff")),
        "w2": ParamDesc((E, eff, d), ("experts", "expert_ff", "embed")),
    }
    if m.n_shared:
        sff = m.n_shared * eff
        descs["shared"] = {
            "w1": ParamDesc((d, sff), ("embed", "ff")),
            "w3": ParamDesc((d, sff), ("embed", "ff")),
            "w2": ParamDesc((sff, d), ("ff", "embed")),
        }
    return descs


def capacity(g: int, k: int, E: int, factor: float) -> int:
    """Slots per expert for a group of `g` tokens: ceil(g k / E * factor),
    at least 4, rounded up to a multiple of 4."""
    c = int(math.ceil(g * k / E * factor))
    return max(4, ((c + 3) // 4) * 4)


def route(cfg: ModelConfig, p, h):
    """h: (B, t, d) -> probs (B, t, E) f32, gate_w (B, t, K) f32 (the top-k
    probabilities, descending, renormalized by their sum) and gate_idx
    (B, t, K)."""
    logits = torch.matmul(h.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = per_row(functools.partial(_top_k, k=cfg.moe.top_k), probs)
    return probs, gate_w, gate_idx


def _top_k(probs, k: int):
    """Each row's k largest probabilities, descending, renormalized by
    their sum, and their experts."""
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), gate_idx


def slots(gate_idx, n_experts: int, c: int):
    """gate_idx: (B, t, K) -> (slot, keep), both (B, K, t).

    An assignment's position in its expert counts the assignments to that
    expert before it in (k, t) order; it is kept if the position is below
    the capacity `c`.  slot = expert * c + position, or the trash slot
    E * c for a dropped assignment."""
    B, t, K = gate_idx.shape
    eid = gate_idx.transpose(1, 2)                                  # (B, K, t)
    idx_km = eid.reshape(B, 1, K * t)                               # k-major
    # one-hot laid out (B, E, K t), so that the count runs along the
    # innermost dim (a scan along an outer dim runs one thread per column)
    oh = torch.zeros((B, n_experts, K * t), dtype=torch.int32, device=gate_idx.device)
    oh.scatter_(1, idx_km, 1)
    pos = torch.cumsum(oh, dim=2, dtype=torch.int32) - 1
    pos_of = torch.gather(pos, 1, idx_km).reshape(B, K, t)
    keep = pos_of < c
    slot = torch.where(keep, eid * c + pos_of, n_experts * c)
    return slot, keep


def _rows(slot, n_experts: int, c: int):
    """Rows of the (E, B, c) buffer flattened, for slots (B, K, t): expert e,
    position i of batch row b is row (e B + b) c + i; a dropped
    assignment's slot E c goes to trash row E B c + b."""
    B = slot.shape[0]
    b = torch.arange(B, device=slot.device)[:, None, None]
    return torch.where(slot < n_experts * c, (slot // c * B + b) * c + slot % c,
                       n_experts * B * c + b)


def _dispatch(mode: str, h, slot, *, n_experts: int, c: int):
    """The expert buffer (E, B, c, d): the token h[b, i] at each kept
    assignment's row; an empty row is zero."""
    B, t, d = h.shape
    K = slot.shape[1]
    n_rows = n_experts * B * c
    rows = _rows(slot, n_experts, c)
    h_flat = h.reshape(B * t, d)
    if mode == "index":
        # scatter only the row -> token map; empty rows read a zero row
        inv = torch.full((n_rows + B,), B * t, dtype=torch.long, device=h.device)
        tok = torch.arange(B * t, device=h.device)
        for k in range(K):
            inv[rows[:, k].reshape(-1)] = tok
        xs = torch.cat([h_flat, h.new_zeros((1, d))])[inv[:n_rows]]
    else:
        xs = h.new_zeros((n_rows + B, d))
        for k in range(K):
            xs.index_add_(0, rows[:, k].reshape(-1), h_flat)
        xs = xs[:n_rows]
    return xs.view(n_experts, B, c, d)


def _route_chunk(cfg: ModelConfig, p, h):
    """h: (B, t, d), one group of each sequence -> (y, aux_loss)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    B, t, d = h.shape
    c = capacity(t, K, E, m.capacity_factor)
    cdt = h.dtype

    probs, gate_w, gate_idx = route(cfg, p, h)
    # Switch balance loss, E * sum_e f_e * P_e per group, averaged over B
    f = per_shard(functools.partial(_load, n_experts=E), [ROWS], [("batch", None)], gate_idx)
    aux = (E * (f * probs.mean(dim=1)).sum(-1)).mean()

    slot, keep = per_shard(functools.partial(slots, n_experts=E, c=c), [ROWS], [ROWS, ROWS],
                           gate_idx)
    xe = per_shard(functools.partial(_dispatch, m.dispatch, n_experts=E, c=c), [ROWS, ROWS],
                   [(None, "batch", None, None)], h, slot)
    xe = _expert_rows(xe).view(E, B * c, d)

    act = L.act_fn(cfg.act)
    a = act(torch.bmm(xe, p["w1"].to(cdt))) * torch.bmm(xe, p["w3"].to(cdt))
    del xe
    ye = _expert_rows(torch.bmm(a, p["w2"].to(cdt)).view(E, B, c, d))
    del a
    return per_shard(_combine, [(None, "batch", None, None), ROWS, ROWS, ROWS], [ROWS],
                     ye, slot, keep, gate_w), aux


def _expert_rows(x):
    """The buffer (E, B, c, d) laid out by `EXPERT_ROWS` under the dry run's
    rules, but where the experts take the data axis and the batch maps to
    (pod, data), the batch keeps the pod: the buffer then moves between the
    batch-local dispatch and the experts by an all-to-all within each pod,
    not a gather across pods.  Elsewhere x."""
    r = active_rules(x)
    if r is None:
        return x
    spec = r.spec(EXPERT_ROWS, x.shape)
    batch = r.rules.get("batch")
    if spec and spec[0] is not None and len(spec) < 2 and isinstance(batch, tuple):
        taken = (spec[0],) if isinstance(spec[0], str) else spec[0]
        rest = tuple(a for a in batch if a not in taken)
        if rest and x.shape[1] % axis_size(r.mesh_shape, rest) == 0:
            spec = (spec[0], rest[0] if len(rest) == 1 else rest)
    return x.redistribute(r.mesh, placements(spec, r.mesh))


def _load(gate_idx, n_experts: int):
    """The fraction of each group's K t assignments that go to each expert:
    (B, t, K) -> (B, E) f32."""
    B, t, K = gate_idx.shape
    return torch.zeros((B, n_experts), device=gate_idx.device).scatter_add_(
        1, gate_idx.reshape(B, K * t),
        torch.ones((B, K * t), device=gate_idx.device)) / (t * K)


def _combine(ye, slot, keep, gate_w):
    """The K-way weighted gather back from the buffer (E, B, c, d):
    y[b, i] = sum_k gate_w[b, i, k] * (expert output at slot[b, k, i]) over
    the kept assignments."""
    B, t, _ = gate_w.shape
    E, _, c, d = ye.shape
    rows = _rows(slot, E, c)
    flat = ye.reshape(E * B * c, d)
    y = ye.new_zeros((B, t, d))
    last = flat.shape[0] - 1
    for k in range(slot.shape[1]):
        kept = keep[:, k, :, None]
        gathered = torch.where(kept, flat[rows[:, k].clamp(max=last)], 0)
        y = y + gate_w[:, :, k, None].to(ye.dtype) * gathered
    return y


def apply_moe(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (x + moe_out, aux_loss * aux_loss_weight).

    The sequence is routed in groups of g = min(group_size, S) tokens, g
    shrunk until it divides S (2049 -> 683); aux is averaged over the
    groups."""
    m = cfg.moe
    B, S, d = x.shape
    h = L.apply_norm(cfg, p["norm"], x)
    g = min(m.group_size, S)
    while S % g:
        g -= 1
    outs = [_route_chunk(cfg, p, h[:, i:i + g]) for i in range(0, S, g)]
    out = torch.cat([y for y, _ in outs], dim=1)
    aux = torch.stack([a for _, a in outs]).mean()

    if m.n_shared:
        sp = p["shared"]
        cdt = h.dtype
        act = L.act_fn(cfg.act)
        z = act(torch.matmul(h, sp["w1"].to(cdt))) * torch.matmul(h, sp["w3"].to(cdt))
        out = add_partial(out, torch.matmul(z, sp["w2"].to(cdt)))
    return L.residual(x, out), aux * m.aux_loss_weight
