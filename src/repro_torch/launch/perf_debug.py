"""Per-op cost attribution of one step: the profile of the dry run.

The counterpart of the JAX package's `repro/launch/perf_debug.py`, which
walks the compiled HLO.  Here `attribute(fn, *args)` runs the step once
under `op_cost`'s counter and groups its collectives and its byte-heavy
ops by (aten op, first call site inside `repro_torch`): the number of
times a group was seen takes the place of the HLO walk's while-loop
multiplicity.  An op of the backward is put at the call site of the
forward op whose gradient it computes, marked "(backward)": autograd's
anomaly mode keeps each node's forward stack, which the counter reads
from the node running.  With `peak`, it also lists the storages live at
the count's peak (`op_cost.Cost.peak_bytes`) by the call site that made
them.  Like `op_cost.analyze`, it runs on whatever tensors it is given
(fake DTensors in the dry run), and no device time is involved.
"""
from __future__ import annotations

import os
import re
import sys
import warnings

import torch

from repro_torch.launch import op_cost

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames that only relay an op: the counter itself and the sharding helpers
_RELAYS = (os.path.join(_PKG, "launch", "op_cost.py"),
           os.path.join(_PKG, "launch", "perf_debug.py"),
           os.path.join(_PKG, "distributed", "sharding.py"))
# a checkpointed region's recompute runs the forward's own frames
_RECOMPUTE = os.path.join("torch", "utils", "checkpoint.py")
_FRAME = re.compile(r'File "([^"]+)", line (\d+)')


def _site(path: str, line) -> str | None:
    if path.startswith(_PKG) and path not in _RELAYS:
        return f"{os.path.relpath(path, os.path.dirname(_PKG))}:{line}"
    return None


def _forward_site(node) -> str | None:
    """The innermost call site in the package of the forward op that made
    autograd node `node`, from anomaly mode's record of its stack."""
    for frame in reversed(node.metadata.get("traceback_") or ()):
        m = _FRAME.search(frame)
        site = m and _site(m.group(1), m.group(2))
        if site:
            return site
    return None


def _call_site() -> str:
    """file:line of the innermost frame in the package outside the relays.
    Inside the backward: a checkpointed region's recompute keeps its own
    frames, marked "(recompute)"; any other op takes the forward call site
    of the node running, marked "(backward)"."""
    f, recompute, site = sys._getframe(1), False, None
    while f is not None:
        path = f.f_code.co_filename
        recompute = recompute or path.endswith(_RECOMPUTE)
        site = site or _site(path, f.f_lineno)
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is None:
        return site or "?"
    if recompute:
        return f"{site} (recompute)"
    return f"{_forward_site(node) or site} (backward)"


class _Attributor(op_cost._OpCounter):
    """The counter, also keeping each op's cost under (op, call site), and
    with `peak_at` (a peak found by an earlier run of the same step), the
    live storages by call site when the count first reaches it."""

    def __init__(self, peak_at: float | None = None):
        super().__init__()
        self.groups: dict = {}
        self.peak_at = peak_at
        self.made: dict = {}      # storage -> (op, call site), while it lives
        self.at_peak: dict | None = None
        self._op = None

    def record(self, func, args, kwargs, out, cost):
        one = op_cost.Cost()
        super().record(func, args, kwargs, out, one)
        super().record(func, args, kwargs, out, cost)
        if not (one.bytes or one.coll_wire or self.peak_at is not None):
            return
        # a collective over one rank moves nothing: listed by its op's name
        kind = next(iter(one.coll_by_kind)) if one.coll_wire else func.overloadpacket.__name__
        self._op = (kind, _call_site())
        if not (one.bytes or one.coll_wire):
            return
        g = self.groups.setdefault(self._op, {"count": 0, "bytes": 0.0, "wire": 0.0})
        g["count"] += 1
        g["bytes"] += one.bytes
        g["wire"] += one.coll_wire

    def _hold(self, outs, ins, own=False, scratch=0):
        if self.peak_at is None:
            return super()._hold(outs, ins, own, scratch)
        op, self._op = self._op or ("replayed", _call_site()), None
        new = [t.untyped_storage()._cdata for t in outs]
        new = [k for k in new if k not in self._held]
        super()._hold(outs, ins, own, scratch)
        for k in new:
            if k in self._held:
                self.made[k] = op
        if self.at_peak is None and self.live + scratch >= self.peak_at:
            self.at_peak = {}
            for k, n in self._held.items():
                g = self.at_peak.setdefault(self.made.get(k, ("?", "?")), [0, 0])
                g[0] += n
                g[1] += 1
            if scratch:
                self.at_peak[(f"{op[0]} scratch", op[1])] = [scratch, 1]

    def _free(self, key):
        super()._free(key)
        self.made.pop(key, None)

    def _pass_on(self, src, dst):
        op = self.made.pop(src.untyped_storage()._cdata, None)
        super()._pass_on(src, dst)
        if op is not None and dst.untyped_storage()._cdata in self._held:
            self.made[dst.untyped_storage()._cdata] = op


def attribute(fn, *args, peak: bool = False):
    """-> (collective records, byte records), each a list of (total, count,
    per call, op, call site), largest total first; with `peak`, also the
    storages live at the count's peak, as (bytes, storages, op, call site)
    records, largest first (the step runs twice: once to find the peak)."""
    target = op_cost.analyze(fn, *args).peak_bytes if peak else None
    att = _Attributor(target)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Anomaly Detection has been enabled")
        with torch.autograd.detect_anomaly(check_nan=False), op_cost.alltoall_as_on_a_card(), att:
            fn(*args)
    coll, byts = [], []
    for (kind, site), g in att.groups.items():
        if g["wire"]:
            coll.append((g["wire"], g["count"], g["wire"] / g["count"], kind, site))
        byts.append((g["bytes"], g["count"], g["bytes"] / g["count"], kind, site))
    coll.sort(reverse=True)
    byts.sort(reverse=True)
    if not peak:
        return coll, byts
    live = sorted(((n, k, op, site) for (op, site), (n, k) in (att.at_peak or {}).items()),
                  reverse=True)
    return coll, byts, live


def report(fn, *args, top: int = 12, peak: bool = False) -> str:
    out = attribute(fn, *args, peak=peak)
    coll, byts = out[:2]
    lines = ["== top collectives (wire bytes x multiplicity) =="]
    for r in coll[:top]:
        lines.append(f"  {r[0]:.3e}  x{r[1]:<5d} per={r[2]:.2e} {r[3]:<14s} {r[4]}")
    lines.append("== collectives by kind ==")
    kinds: dict = {}
    for r in coll:
        k = kinds.setdefault(r[3], [0, 0.0])
        k[0] += r[1]
        k[1] += r[0]
    for kind, (n, wire) in sorted(kinds.items()):
        lines.append(f"  {kind:<14s} x{n:<5d} {wire:.3e}")
    lines.append("== top HBM ops ==")
    for r in byts[:top]:
        lines.append(f"  {r[0]:.3e}  x{r[1]:<5d} per={r[2]:.2e} {r[3]:<18s} {r[4]}")
    if peak:
        live = out[2]
        lines.append(f"== live at the peak ({sum(r[0] for r in live):.3e} bytes) ==")
        for r in live[:top]:
            lines.append(f"  {r[0]:.3e}  x{r[1]:<5d} {r[2]:<18s} {r[3]}")
    return "\n".join(lines)


def decode_collectives(cfg) -> dict:
    """The collectives, by kind, that a decode step of `cfg` must send
    under the dry run's decode rules, with the heads dividing "model" and
    the global attention cache sharded along T over it: one all-reduce per
    block output (mixer, cross-attention, FFN) at the residual add, and one
    for the embedding's sum; four all-gathers per global attention layer
    (q heads, new k and v rows, the split-T partials) and three per MLA
    layer (the absorbed query's two parts, the partials), none per ring
    layer; per RG-LRU layer its two gate products reduce-scattered into the
    state's layout; per Mamba layer `x_proj`'s product all-reduced and
    in_proj's two halves gathered; per MoE layer with shared experts their
    all-reduce beside the routed experts' (in the expert buffer); per
    cross-attention layer the cross cache's k and v laid out by heads, one
    all-to-all each; and the logits gathered along the vocab."""
    ar, ag, rs, a2a = 1, 1, 0, 0
    for pattern, reps in cfg.blocks:
        for s in pattern:
            ar += reps * (1 + (s.ffn != "none") + s.cross_attn)
            if s.mixer == "attn" and not s.window:
                ag += 4 * reps
            elif s.mixer == "mla":
                ag += 3 * reps
            elif s.mixer == "rglru":
                rs += 2 * reps
            elif s.mixer == "mamba":
                ar, ag = ar + reps, ag + 2 * reps
            if s.ffn == "moe":
                ar += reps * (cfg.moe.n_shared > 0)
            a2a += 2 * reps * s.cross_attn
    return {k: n for k, n in (("all-reduce", ar), ("all-gather", ag), ("reduce-scatter", rs),
                              ("all-to-all", a2a)) if n}


def cell_report(arch: str, shape: str, *, multi_pod: bool = False, top: int = 12,
                peak: bool = False) -> str:
    """`report` of one dry-run cell's step (`launch/dryrun.py`), on the
    production mesh of a fake world, after a first pass that fills
    DTensor's caches (as `run_cell` does)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import AxisRules, use_axis_rules
    from repro_torch.launch.dryrun import _step_call
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import input_specs

    mesh = make_production_mesh(multi_pod=multi_pod)
    spec = input_specs(arch, shape, mesh)
    call = _step_call(spec)
    with implicit_replication(), use_axis_rules(AxisRules(spec.rules, mesh)):
        op_cost.analyze(call)
        return report(call, top=top, peak=peak)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="collectives and byte-heavy ops of one "
                                             "dry-run cell, by (aten op, call site)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--peak", action="store_true",
                    help="also list the storages live at the count's peak, by call site")
    args = ap.parse_args(argv)
    print(cell_report(args.arch, args.shape, multi_pod=args.multi_pod, top=args.top,
                      peak=args.peak))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
