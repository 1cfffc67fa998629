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

A third mode, "dropless", serves a layer that holds only some of the
experts (`MoEConfig.n_held` from `first_held`, the card's share under
expert parallelism; all of them by default): the router still scores all
`n_experts`, and every assignment to a held expert is computed, at any
skew, with no host synchronisation.  The assignments are sorted by held
expert on the device (the others last), the counts' running sums are the
group offsets of `torch._grouped_mm`, whose three products compute each
held expert's rows, and each assignment's row goes back to its token and
is weighted by its gate.  What the absent experts would add is left out:
another card adds it.  No capacity, no group.  `MoEConfig.renormalize`
off uses the top-k probabilities as they are (Jamba).

While the profiler records (`spans.recording`), each layer also counts,
in device tensors, its assignments, those to held experts (per expert)
and those dropped past capacity (`counters`); otherwise it pays one flag
check and launches nothing for them.  Under the dry run's rules it counts
nothing.

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
from repro_torch.models.spans import recording, span

EXPERT_ROWS = ("experts", "batch", None, None)   # the buffer, (E, B, c, d)
ROWS = ("batch", None, None)                      # per batch row: (B, t, .) or (B, K, t)


def moe_descs(cfg: ModelConfig):
    m = cfg.moe
    d, E, eff = cfg.d_model, m.held, m.expert_ff
    descs = {
        "norm": L.norm_descs(cfg),
        # the router is read in f32, so it is stored in f32 in any compute
        # dtype; it scores every expert, held here or not
        "router": ParamDesc((d, m.n_experts), ("embed", "experts"), f32=True),
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
    probabilities, descending, renormalized by their sum unless
    `renormalize` is off) and gate_idx (B, t, K)."""
    logits = torch.matmul(h.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = per_row(functools.partial(_top_k, k=cfg.moe.top_k,
                                                 renormalize=cfg.moe.renormalize), probs)
    return probs, gate_w, gate_idx


def _top_k(probs, k: int, renormalize: bool = True):
    """Each row's k largest probabilities, descending, renormalized by
    their sum if `renormalize`, and their experts."""
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    if not renormalize:
        return gate_w, gate_idx
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

    with span("repro.moe.route"):
        probs, gate_w, gate_idx = route(cfg, p, h)
        aux = _balance(probs, gate_idx, E)
        slot, keep = per_shard(functools.partial(slots, n_experts=E, c=c), [ROWS],
                               [ROWS, ROWS], gate_idx)
        if _counting(gate_idx):
            _count(p, torch.zeros(E, dtype=torch.long, device=h.device).index_add_(
                0, gate_idx.reshape(-1), torch.ones_like(gate_idx.reshape(-1))),
                gate_idx.numel(), (~keep).sum())
        xe = per_shard(functools.partial(_dispatch, m.dispatch, n_experts=E, c=c),
                       [ROWS, ROWS], [(None, "batch", None, None)], h, slot)
        xe = _expert_rows(xe).view(E, B * c, d)

    with span("repro.moe.experts"):
        act = L.act_fn(cfg.act)
        a = act(torch.bmm(xe, p["w1"].to(cdt))) * torch.bmm(xe, p["w3"].to(cdt))
        del xe
        ye = _expert_rows(torch.bmm(a, p["w2"].to(cdt)).view(E, B, c, d))
        del a
    with span("repro.moe.combine"):
        return per_shard(_combine, [(None, "batch", None, None), ROWS, ROWS, ROWS], [ROWS],
                         ye, slot, keep, gate_w), aux


def _balance(probs, gate_idx, n_experts: int):
    """The Switch balance loss, E * sum_e f_e * P_e per group (B, t, .),
    averaged over B."""
    f = per_shard(functools.partial(_load, n_experts=n_experts), [ROWS], [("batch", None)],
                  gate_idx)
    return (n_experts * (f * probs.mean(dim=1)).sum(-1)).mean()


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


def _held_offsets(gate_idx, first: int, n_held: int):
    """gate_idx (N, K) -> (order, offs, held): `order` the assignments
    (flat, token-major) sorted by held expert, stably, the others last;
    `offs` (n_held,) int32 the running sums of the held experts' counts
    (each group's end, `torch._grouped_mm`'s offsets); `held` (N K,) bool,
    in sorted order, whether the assignment's expert is held.  All on the
    device: a search of the sorted keys, no count read back."""
    local = gate_idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < n_held), local, n_held)
    key, order = torch.sort(key, stable=True)
    ends = torch.arange(n_held, device=key.device, dtype=key.dtype)
    offs = torch.searchsorted(key, ends, right=True).to(torch.int32)
    return order, offs, key < n_held


def _apply_dropless(cfg: ModelConfig, p, x):
    """The "dropless" mode: x (B, S, d) -> (x + moe_out, aux); aux over one
    group a sequence."""
    m = cfg.moe
    B, S, d = x.shape
    K = m.top_k
    with span("repro.moe.route"):
        h = L.apply_norm(cfg, p["norm"], x)
        cdt = h.dtype
        probs, gate_w, gate_idx = route(cfg, p, h)
        aux = _balance(probs, gate_idx, m.n_experts)
        order, offs, held = _held_offsets(gate_idx.reshape(B * S, K), m.first_held, m.held)
        if _counting(gate_idx):
            _count(p, torch.diff(offs, prepend=offs.new_zeros(1)).long(), B * S * K, 0)
        xs = h.reshape(B * S, d)[order // K]
    with span("repro.moe.experts"):
        # rows offs[e-1]:offs[e] by held expert e's matrices; the rows past
        # offs[-1] (unheld experts') are left unwritten
        act = L.act_fn(cfg.act)
        a = act(torch._grouped_mm(xs, p["w1"].to(cdt), offs=offs)) \
            * torch._grouped_mm(xs, p["w3"].to(cdt), offs=offs)
        del xs
        ys = torch._grouped_mm(a, p["w2"].to(cdt), offs=offs)
        del a
    with span("repro.moe.combine"):
        ys = torch.where(held[:, None], ys, 0)
        back = torch.empty_like(ys).index_copy_(0, order, ys).view(B, S, K, d)
        out = gate_w[:, :, 0, None].to(cdt) * back[:, :, 0]
        for k in range(1, K):
            out = out + gate_w[:, :, k, None].to(cdt) * back[:, :, k]
        return L.residual(x, out), aux * m.aux_loss_weight


# per-layer counts, while the profiler records: the layer's router (a view
# of its group's stacked tensor) names the layer
_COUNTS: dict[int, list] = {}


def _counting(gate_idx) -> bool:
    """Whether the layer counts: while the profiler records, and not under
    the dry run's rules (a serving card's counters, not a sharded step's)."""
    return recording() and active_rules(gate_idx) is None


def _count(p, per_expert, assigned: int, dropped):
    """Add one call's counts to the layer's: `per_expert` (held experts,)
    assignments routed to each, `assigned` all K t of the call, `dropped`
    those past capacity (a tensor or 0)."""
    _COUNTS.setdefault(p["router"].data_ptr(), []).append((per_expert, assigned, dropped))


def counters() -> list[dict]:
    """Each MoE layer's counts since `reset_counters`, in the order the
    layers first ran: {"assigned", "held", "dropped", "per_expert" (a list
    per held expert), "calls" (each call's per-expert list)}."""
    out = []
    for calls in _COUNTS.values():
        per_call = [c.tolist() for c, _, _ in calls]
        per_expert = [sum(col) for col in zip(*per_call)]
        out.append({"assigned": sum(a for _, a, _ in calls), "held": sum(per_expert),
                    "dropped": sum(int(dr) for _, _, dr in calls),
                    "per_expert": per_expert, "calls": per_call})
    return out


def reset_counters():
    _COUNTS.clear()


def apply_moe(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (x + moe_out, aux_loss * aux_loss_weight).

    The "dropless" mode: `_apply_dropless`.  Otherwise the sequence is
    routed in groups of g = min(group_size, S) tokens, g shrunk until it
    divides S (2049 -> 683); aux is averaged over the groups."""
    m = cfg.moe
    if m.dispatch == "dropless":
        return _apply_dropless(cfg, p, x)
    if m.held != m.n_experts:
        raise ValueError(f"a layer that holds {m.held} of {m.n_experts} experts needs the "
                         f"dropless dispatch; got {m.dispatch!r}")
    B, S, d = x.shape
    with span("repro.moe.route"):
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
