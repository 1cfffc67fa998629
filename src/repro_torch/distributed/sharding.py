"""Logical-axis sharding constraints for activations.

Model code annotates intermediates with *logical* axes
(``constrain(x, ("batch", None, "heads", None))``).  When an `AxisRules`
context is active (set up by the dry run) and `x` is a DTensor, these
resolve with divisibility fallback to a `redistribute` onto the mesh's
placements (the counterpart of the JAX package's
`jax.lax.with_sharding_constraint`); otherwise they are no-ops, so the
served and trained paths on one card see none of this.

`per_shard` runs a function on each rank's local shards, `write_row`
writes one row into a cache sharded along its rows (only the rank that
holds the row writes), and `gather_last` picks one entry of a row whose
last dim is sharded (the loss's label logit over a vocab-sharded row):
also only under active rules.  `active_rules` lets model code choose a
partition of its own (query rows, split-T decode) where the rules' layout
alone would replicate the work.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Any

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.models.params import (axis_size, contiguous_strides, mesh_shape,
                                       placements, resolve_axes)

# one for the process, not one per thread: on a card the autograd engine
# runs the backward, and with it each checkpointed region's recompute, on a
# thread of its own, which must take the partitions the forward took
_STATE = SimpleNamespace(rules=None)


class AxisRules:
    def __init__(self, rules: dict[str, Any], mesh):
        self.rules = rules
        self.mesh = mesh
        self.mesh_shape = mesh_shape(mesh)

    def spec(self, axes, shape) -> tuple:
        return resolve_axes(shape, axes, self.rules, self.mesh_shape)


@contextlib.contextmanager
def use_axis_rules(rules: AxisRules | None):
    prev = _STATE.rules
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> AxisRules | None:
    return _STATE.rules


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def active_rules(*xs) -> AxisRules | None:
    """The active rules when any of `xs` is a DTensor, else None: the test
    by which a sharded path is taken only under the dry run's rules."""
    r = current_rules()
    return r if r is not None and any(_is_dtensor(x) for x in xs) else None


def constrain(x, axes):
    """Annotate activation x with logical axes; a no-op without active rules
    or when x is not a DTensor."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} do not match a tensor of shape {tuple(x.shape)}")
    return x.redistribute(r.mesh, placements(r.spec(axes, x.shape), r.mesh))


def _names(mesh_axes) -> tuple:
    if mesh_axes is None:
        return ()
    return (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)


def per_shard(fn, in_axes, out_axes, *args):
    """fn on each rank's shards, for a computation that is local along every
    dim its logical axes shard (a scan over the sequence, elementwise in
    batch and width).

    Under active rules, each DTensor argument (and each plain tensor, taken
    as replicated) is first laid out by its entry of `in_axes`, fn runs
    once on the local shards, and each of its outputs becomes a DTensor
    sharded as the inputs' dims of the same logical axis were (an axis no
    input shards stays whole).  An input
    whole along a mesh dim that splits an output gets its gradient as a
    partial sum over that dim's ranks, reduced where DTensor next needs it
    whole (k and v gathered for a rank's query rows).  One DTensor
    dispatch in place of one per op inside fn, and, under the dry run's
    counter, one trace of fn per shape (the current dispatch mode's
    `once_per_shape`, where it has one).  Otherwise fn(*args).
    """
    r = current_rules()
    if r is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    specs, mapped = [], {}
    for a, axes in zip(args, in_axes):
        spec = r.spec(axes, a.shape) if isinstance(a, torch.Tensor) else None
        for i, ax in enumerate(axes if spec is not None else ()):
            if ax is not None:
                mapped.setdefault(ax, spec[i] if i < len(spec) else None)
        specs.append(spec)
    # a mesh dim that splits an output but not an input: each rank's
    # gradient of that input is a partial sum over the dim's ranks
    split = {n for axes in out_axes for ax in axes if ax is not None
             for n in _names(mapped.get(ax))}
    local = []
    for a, spec in zip(args, specs):
        if spec is not None and (spec or _is_dtensor(a)):
            pl = placements(spec, r.mesh)
            if not _is_dtensor(a):
                # a plain tensor counts as replicated, as under
                # `implicit_replication`
                a = DTensor.from_local(a, r.mesh, [Replicate()] * r.mesh.ndim, run_check=False)
            grad = [Partial() if p.is_replicate() and name in split else p
                    for p, name in zip(pl, r.mesh.mesh_dim_names)]
            a = a.redistribute(r.mesh, pl).to_local(grad_placements=grad)
        local.append(a)
    run = getattr(_get_current_dispatch_mode(), "once_per_shape", None)
    out = fn(*local) if run is None else run(fn, *local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = []
    for t, axes in zip(outs, out_axes):
        t = t.contiguous()      # the DTensor below declares contiguous strides
        spec = [mapped.get(ax) if ax is not None else None for ax in axes]
        while spec and spec[-1] is None:
            spec.pop()
        shape = tuple(n * axis_size(r.mesh_shape, spec[i] if i < len(spec) else None)
                      for i, n in enumerate(t.shape))
        wrapped.append(DTensor.from_local(t, r.mesh, placements(tuple(spec), r.mesh),
                                          run_check=False, shape=torch.Size(shape),
                                          stride=contiguous_strides(shape)))
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]


def write_row(t, index: int, row):
    """``t[:, index] = row`` in place: one row of a cache (B, T, ...).

    Under active rules with `t` a DTensor, each rank writes into its own
    shard, and only the rank whose slice of dim 1 holds `index`; `row` is
    first laid out as `t` is but along dim 1 (DTensor's own write into a
    row of a dim it shards gathers the whole cache).  Otherwise the plain
    write."""
    r = current_rules()
    if r is None or not _is_dtensor(t):
        t[:, index] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    pl = [Replicate() if p.is_shard(1) else
          Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p for p in t.placements]
    if _is_dtensor(row):
        row = row.redistribute(r.mesh, pl).to_local()
    local = t.to_local()
    _, offset = compute_local_shape_and_global_offset(t.shape, r.mesh, t.placements)
    if 0 <= index - offset[1] < local.shape[1]:
        local[:, index - offset[1]] = row


def gather_last(x, index):
    """``torch.gather(x, -1, index)``, with `index` of size 1 in the last dim.

    Under active rules with x a DTensor sharded along its last dim (the
    vocab of a logits row), each rank picks from its own slice, the ranks
    whose slice misses the index give 0, and the picks are summed across
    the ranks that split the row: the vocab-parallel pick, one small
    all-reduce (DTensor's own gather along a sharded dim fails).
    Otherwise ``torch.gather`` as it is.
    """
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return torch.gather(x, -1, index)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    last = x.ndim - 1
    xp = x.placements
    cut = [p.is_shard(last) for p in xp]        # the mesh dims that split a row
    ip = [Replicate() if c else p for p, c in zip(xp, cut)]
    local = x.to_local()
    _, offset = compute_local_shape_and_global_offset(x.shape, r.mesh, xp)
    n = local.shape[last]
    j = index.redistribute(r.mesh, ip).to_local() - offset[last]
    pick = torch.where((j >= 0) & (j < n), torch.gather(local, -1, j.clamp(0, n - 1)), 0.0)
    shape = tuple(index.shape)
    out = DTensor.from_local(pick, r.mesh, [Partial() if c else p for p, c in zip(ip, cut)],
                             run_check=False, shape=torch.Size(shape),
                             stride=contiguous_strides(shape))
    return out.redistribute(r.mesh, ip)
