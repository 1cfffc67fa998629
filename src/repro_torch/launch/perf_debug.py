"""Per-op cost attribution of one step: the profile of the dry run.

The counterpart of the JAX package's `repro/launch/perf_debug.py`, which
walks the compiled HLO.  Here `attribute(fn, *args)` runs the step once
under `op_cost`'s counter and groups its collectives and its byte-heavy
ops by (aten op, first call site inside `repro_torch`): the number of
times a group was seen takes the place of the HLO walk's while-loop
multiplicity.  Like `op_cost.analyze`, it runs on whatever tensors it is
given (fake DTensors in the dry run), and no device time is involved.
"""
from __future__ import annotations

import os
import sys

from repro_torch.launch import op_cost

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames that only relay an op: the counter itself and the sharding helpers
_RELAYS = (os.path.join(_PKG, "launch", "op_cost.py"),
           os.path.join(_PKG, "launch", "perf_debug.py"),
           os.path.join(_PKG, "distributed", "sharding.py"))


def _call_site() -> str:
    """file:line of the innermost frame in the package outside the relays."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path not in _RELAYS:
            return f"{os.path.relpath(path, os.path.dirname(_PKG))}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _Attributor(op_cost._OpCounter):
    """The counter, also keeping each op's cost under (op, call site)."""

    def __init__(self):
        super().__init__()
        self.groups: dict = {}

    def record(self, func, args, kwargs, out, cost):
        one = op_cost.Cost()
        super().record(func, args, kwargs, out, one)
        super().record(func, args, kwargs, out, cost)
        if not (one.bytes or one.coll_wire):
            return
        kind = next(iter(one.coll_by_kind), func.overloadpacket.__name__)
        g = self.groups.setdefault((kind, _call_site()),
                                   {"count": 0, "bytes": 0.0, "wire": 0.0})
        g["count"] += 1
        g["bytes"] += one.bytes
        g["wire"] += one.coll_wire


def attribute(fn, *args):
    """-> (collective records, byte records), each a list of (total, count,
    per call, op, call site), largest total first."""
    att = _Attributor()
    with op_cost.alltoall_as_on_a_card(), att:
        fn(*args)
    coll, byts = [], []
    for (kind, site), g in att.groups.items():
        if g["wire"]:
            coll.append((g["wire"], g["count"], g["wire"] / g["count"], kind, site))
        byts.append((g["bytes"], g["count"], g["bytes"] / g["count"], kind, site))
    coll.sort(reverse=True)
    byts.sort(reverse=True)
    return coll, byts


def report(fn, *args, top: int = 12) -> str:
    coll, byts = attribute(fn, *args)
    lines = ["== top collectives (wire bytes x multiplicity) =="]
    for r in coll[:top]:
        lines.append(f"  {r[0]:.3e}  x{r[1]:<5d} per={r[2]:.2e} {r[3]:<14s} {r[4]}")
    lines.append("== top HBM ops ==")
    for r in byts[:top]:
        lines.append(f"  {r[0]:.3e}  x{r[1]:<5d} per={r[2]:.2e} {r[3]:<18s} {r[4]}")
    return "\n".join(lines)


def cell_report(arch: str, shape: str, *, multi_pod: bool = False, top: int = 12) -> str:
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
    call = _step_call(spec, False)
    with implicit_replication(), use_axis_rules(AxisRules(spec.rules, mesh)):
        op_cost.analyze(call)
        return report(call, top=top)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="collectives and byte-heavy ops of one "
                                             "dry-run cell, by (aten op, call site)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    print(cell_report(args.arch, args.shape, multi_pod=args.multi_pod, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
