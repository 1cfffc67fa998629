"""Logical-axis sharding constraints for activations.

Model code annotates intermediates with *logical* axes
(``constrain(x, ("batch", None, "heads", None))``).  When an `AxisRules`
context is active (set up by the dry run) and `x` is a DTensor, these
resolve with divisibility fallback to a `redistribute` onto the mesh's
placements (the counterpart of the JAX package's
`jax.lax.with_sharding_constraint`); otherwise they are no-ops, so the
served and trained paths on one card see none of this.

`replicated` runs an op that DTensor has no sharding strategy for
(`scatter_add_`, `index_add_`, writes into a cache slice) on full replicas,
and `gather_last` picks one entry of a row whose last dim is sharded (the
loss's label logit over a vocab-sharded row): also only under active rules.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.models.params import (axis_size, contiguous_strides, mesh_shape,
                                       placements, resolve_axes)

_STATE = threading.local()


class AxisRules:
    def __init__(self, rules: dict[str, Any], mesh):
        self.rules = rules
        self.mesh = mesh
        self.mesh_shape = mesh_shape(mesh)

    def spec(self, axes, shape) -> tuple:
        return resolve_axes(shape, axes, self.rules, self.mesh_shape)


@contextlib.contextmanager
def use_axis_rules(rules: AxisRules | None):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> AxisRules | None:
    return getattr(_STATE, "rules", None)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, axes):
    """Annotate activation x with logical axes; a no-op without active rules
    or when x is not a DTensor."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} do not match a tensor of shape {tuple(x.shape)}")
    return x.redistribute(r.mesh, placements(r.spec(axes, x.shape), r.mesh))


def per_shard(fn, in_axes, out_axes, *args):
    """fn on each rank's shards, for a computation that is local along every
    dim its logical axes shard (a scan over the sequence, elementwise in
    batch and width).

    Under active rules, each DTensor argument is first laid out by its
    entry of `in_axes`, fn runs once on the local shards, and each of its
    outputs becomes a DTensor sharded as the inputs' dims of the same
    logical axis were (an axis no input shards stays whole): one DTensor
    dispatch in place of one per op inside fn, and, under the dry run's
    counter, one trace of fn per shape (the current dispatch mode's
    `once_per_shape`, where it has one).  Otherwise fn(*args).
    """
    r = current_rules()
    if r is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor

    local, mapped = [], {}
    for a, axes in zip(args, in_axes):
        if _is_dtensor(a):
            spec = r.spec(axes, a.shape)
            for i, ax in enumerate(axes):
                if ax is not None:
                    mapped.setdefault(ax, spec[i] if i < len(spec) else None)
            a = a.redistribute(r.mesh, placements(spec, r.mesh)).to_local()
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


def replicated(fn, *args):
    """fn(*args) for an op with no DTensor sharding strategy.

    Under active rules, DTensor arguments are gathered to full replicas, fn
    runs on their local tensors, and every tensor it returns comes back as a
    replicated DTensor on the rules' mesh.  Otherwise fn(*args) as it is.
    """
    r = current_rules()
    if r is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * r.mesh.ndim
    local = [a.redistribute(r.mesh, rep).to_local() if _is_dtensor(a) else a
             for a in args]
    out = fn(*local)

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, r.mesh, rep, run_check=False)
        return t

    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


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
