"""Logical-axis sharding constraints for activations.

Model code annotates intermediates with *logical* axes
(``constrain(x, ("batch", None, "heads", None))``).  When an `AxisRules`
context is active (set up by the dry run) and `x` is a DTensor, these
resolve with divisibility fallback to a `redistribute` onto the mesh's
placements (the counterpart of the JAX package's
`jax.lax.with_sharding_constraint`); otherwise they are no-ops, so the
served and trained paths on one card see none of this.

`embed_rows` looks up token rows in a vocab-sharded table, each rank in
its own rows; `add_partial`, `add_whole` and `partial_grad` keep a sum of
whole and partial tensors (or of their gradients) partial, without a
collective, where DTensor's own rule for the add differs between torch
versions; `lay_out` lays a tensor out by DTensor placements.
`per_shard` runs a function on each rank's local shards, `per_row` a
function of each row on each rank's own rows, in the tensor's layout,
`write_row` writes one row into a cache sharded along its rows (only the
rank that holds the row writes), `gather_last` picks one entry of a row
whose last dim is sharded (the loss's label logit over a vocab-sharded
row), and `logsumexp_last` takes such a row's log-sum-exp on each rank's
own columns: also only under active rules.  `active_rules` lets model
code choose a partition of its own (query rows, split-T decode) where the
rules' layout alone would replicate the work.
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
    or when x is not a DTensor.  A partial sum that the layout makes whole
    along a mesh dim is reduced by one all-reduce over that dim, explicitly
    (`_redistribute`)."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} do not match a tensor of shape {tuple(x.shape)}")
    return _redistribute(r, x, placements(r.spec(axes, x.shape), r.mesh))


def lay_out(x, placements):
    """x laid out by DTensor `placements` under active rules (`constrain`'s
    step, for a layout not named by logical axes: a gradient laid out as
    its optimizer state is); otherwise x."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    return _redistribute(r, x, list(placements))


def _redistribute(r, x, target):
    """``x.redistribute(mesh, target)``, but each plain partial sum that
    `target` makes whole along a mesh dim is first reduced by one
    all-reduce over that dim (`_Reduce`).  DTensor's own planner makes
    that step an all-reduce on some torch versions and a reduce-scatter and
    an all-gather on others; here it is one collective of one kind on all."""
    from torch.distributed.tensor import Partial

    dims = tuple(i for i, (p, t) in enumerate(zip(x.placements, target))
                 if type(p) is Partial and _is_sum(p) and t.is_replicate())
    if dims:
        x = _Reduce.apply(x, r, dims)
    return x.redistribute(r.mesh, target)


def _with(x, local, placements):
    """A DTensor of x's shape on x's mesh from `local`, laid out by
    `placements`."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _grad_layout(placements) -> list:
    """The layout of the gradient of a tensor laid out by `placements`: a
    partial sum's gradient is whole, as DTensor passes it back."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial() else p for p in placements]


def _as_partial(r, x, dims):
    """x as a partial sum over mesh dims `dims` (no collective): where x is
    whole along one, kept on its first rank and 0 on the others; where x
    is a partial mean (torch 2.11's mean over a sharded dim), each rank's
    part divided by the dim's size.  Any other layout along such a dim (a
    shard, another reduction) raises: the caller lays x out first."""
    from torch.distributed.tensor import Partial

    local = x.to_local()
    for d in dims:
        p = x.placements[d]
        if p.is_replicate():
            if r.mesh.get_local_rank(d):
                local = torch.zeros_like(local)
        elif p.is_partial() and p.reduce_op == "avg":
            local = local / r.mesh.size(d)
        else:
            raise ValueError(f"cannot make {p} along mesh dim {d} a partial sum "
                             "without a collective: lay the term out first")
    return _with(x, local, [Partial() if i in dims else p for i, p in enumerate(x.placements)])


def _is_sum(p) -> bool:
    return p.is_partial() and p.reduce_op == "sum"


class _Reduce(torch.autograd.Function):
    """x's partial sums along mesh dims `dims` reduced, one all-reduce
    each.  The gradient is the sum's gradient, laid out whole along those
    dims, as DTensor's own Partial -> Replicate step passes it back."""

    @staticmethod
    def forward(ctx, x, r, dims):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import Replicate

        local = x.to_local()
        for d in dims:
            local = funcol.wait_tensor(funcol.all_reduce(local, "sum",
                                                         r.mesh.get_group(d).group_name))
        pl = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
        ctx.r, ctx.pl = r, _grad_layout(pl)
        return _with(x, local, pl)

    @staticmethod
    def backward(ctx, grad):
        return _redistribute(ctx.r, grad, ctx.pl), None, None


class _AsPartial(torch.autograd.Function):
    """`_as_partial`, whose gradient comes back laid out as x's (whole where
    x is whole or a partial mean)."""

    @staticmethod
    def forward(ctx, x, r, dims):
        ctx.r, ctx.pl = r, _grad_layout(x.placements)
        return _as_partial(r, x, dims)

    @staticmethod
    def backward(ctx, grad):
        return _redistribute(ctx.r, grad, ctx.pl), None, None


class _PartialGrad(torch.autograd.Function):
    """The identity, whose gradient, where it comes back whole along mesh
    dims `dims`, goes on as a partial sum over them (`_AsPartial`'s
    step)."""

    @staticmethod
    def forward(ctx, x, r, dims):
        ctx.r, ctx.dims = r, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        dims = tuple(d for d in ctx.dims if grad.placements[d].is_replicate())
        return _as_partial(ctx.r, grad, dims) if dims else grad, None, None


def add_partial(*xs):
    """xs[0] + xs[1] + ..., where some terms hold partial sums along mesh
    dims (a product over a dim's shards, a mean over the batch shards) and
    others are whole along them (a bias, a path computed whole, a number).
    Under active rules each term whole along such a dim is first made a
    partial sum over it (`_AsPartial`, no collective; a number or a plain
    tensor counts as whole), so that the total is one partial sum, reduced
    once where the layout next needs it: DTensor's own add of a whole and
    a partial term reduces the partial one on some torch versions and
    splits the whole one on others.  A term sharded along such a dim
    raises: the caller lays it out first.  Otherwise the plain sum."""
    r = current_rules()
    dims = set() if r is None else {i for x in xs if _is_dtensor(x)
                                    for i, p in enumerate(x.placements) if p.is_partial()}
    if dims:
        # a partial mean is made a partial sum as well, so that every term
        # is of one kind (DTensor adds no two kinds of partial)
        from torch.distributed.tensor import DTensor, Replicate

        terms = []
        for x in xs:
            if not _is_dtensor(x):
                x = DTensor.from_local(torch.as_tensor(x, dtype=torch.float32), r.mesh,
                                       [Replicate()] * r.mesh.ndim, run_check=False)
            other = tuple(i for i in sorted(dims) if not _is_sum(x.placements[i]))
            terms.append(_AsPartial.apply(x, r, other) if other else x)
        xs = terms
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def add_whole(*xs):
    """`add_partial(*xs)`, its partial sums then reduced, one all-reduce per
    mesh dim: whole on every rank."""
    total = add_partial(*xs)
    r = current_rules()
    if r is None or not _is_dtensor(total):
        return total
    return _redistribute(r, total, _grad_layout(total.placements))


def partial_grad(x, axis: str):
    """x, whose gradient, where it comes back whole along the mesh dims of
    logical `axis`, goes on as a partial sum over them (kept on each dim's
    first rank, 0 on the others: no collective).  For a tensor read both
    by a use that passes its gradient back whole (a `per_shard` call, a
    product with whole weights) and by one that passes it back as a
    partial sum over `axis` (a product over `axis`' shards): the two then
    add up to one partial sum, reduced once where the layout next needs
    it, where DTensor's own add of the two picks the reduction by torch
    version.  A no-op without active rules."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    names = _names(r.rules.get(axis))
    dims = tuple(i for i, n in enumerate(r.mesh.mesh_dim_names)
                 if n in names and r.mesh_shape[n] > 1)
    return _PartialGrad.apply(x, r, dims) if dims else x


def _names(mesh_axes) -> tuple:
    if mesh_axes is None:
        return ()
    return (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)


def per_row(fn, x):
    """fn(x), for an fn that works on each row of x (its last dim) alone and
    returns one tensor, or a tuple of them, with x's leading dims (each
    row's top k).

    Under active rules with x a DTensor whose last dim no mesh dim splits
    and which holds no partial sum, fn runs on each rank's own rows and
    each result is laid out as x is, forward and backward: no collective,
    where DTensor's own rules for fn's ops gather on some torch versions
    (the backward of a top-k, on torch 2.11).  Otherwise fn(x)."""
    r = current_rules()
    if r is None or not _is_dtensor(x) or any(p.is_partial() or p.is_shard(x.ndim - 1)
                                             for p in x.placements):
        return fn(x)
    from torch.distributed.tensor import DTensor

    def rows(t):
        shape = tuple(x.shape[:-1]) + tuple(t.shape[-1:])
        return DTensor.from_local(t, r.mesh, x.placements, run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_strides(shape))

    out = fn(x.to_local())
    return tuple(map(rows, out)) if isinstance(out, tuple) else rows(out)


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


def embed_rows(table, tokens, dtype):
    """``F.embedding(tokens, table).to(dtype)``.

    Under active rules with `table` a DTensor whose rows (the vocab) shard,
    each rank looks up its own rows, the tokens outside them give 0, and
    the result, cast here, holds plain partial sums over the mesh dims
    that split the vocab, to be reduced where the caller lays it out
    (`constrain`).  DTensor's own lookup leaves a masked partial sum, whose
    reduction each torch version plans its own way.  Otherwise the plain
    lookup.
    """
    r = current_rules()
    if r is None or not _is_dtensor(table) or not any(
            p.is_shard(0) for p in table.placements):
        return torch.nn.functional.embedding(tokens, table).to(dtype)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    tp = table.placements
    cut = [p.is_shard(0) for p in tp]
    if not _is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, r.mesh, [Replicate()] * r.mesh.ndim,
                                    run_check=False)
    ip = [Replicate() if c else p for p, c in zip(tokens.placements, cut)]
    idx = tokens.redistribute(r.mesh, ip).to_local()
    # the table's rows are whole along a mesh dim that splits the tokens:
    # each rank's gradient of them is a partial sum over that dim
    local = table.to_local(grad_placements=[
        Partial() if p.is_replicate() and q.is_shard() and n > 1 else p
        for p, q, n in zip(tp, ip, r.mesh.shape)])
    _, offset = compute_local_shape_and_global_offset(table.shape, r.mesh, tp)
    n = local.shape[0]
    j = idx - offset[0]
    rows = torch.nn.functional.embedding(j.clamp(0, n - 1), local).to(dtype)
    rows = torch.where(((j >= 0) & (j < n))[..., None], rows, 0)
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(rows, r.mesh, [Partial() if c else p for p, c in zip(ip, cut)],
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


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
    return _redistribute(r, out, ip)


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``.

    Under active rules with x a DTensor sharded along its last dim (the
    vocab of a logits row), each rank works on its own slice: the ranks
    that split the row agree on its max by one all-reduce of their local
    maxes (no gradient: the result does not depend on it), each sums
    exp(x - max) over its own columns, and one explicit all-reduce of the
    sums (`_Reduce`) completes the row.  The gradient, softmax(x) times
    the result's, stays on each rank's own columns.  DTensor's own
    `logsumexp` over a sharded dim gathers the whole row on every rank.
    Otherwise (a row not split, or x holding a partial sum)
    ``torch.logsumexp`` as it is."""
    r = current_rules()
    last = x.ndim - 1
    if (r is None or not _is_dtensor(x) or not any(p.is_shard(last) for p in x.placements)
            or any(p.is_partial() for p in x.placements)):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate

    cut = tuple(i for i, p in enumerate(x.placements) if p.is_shard(last))
    local = x.to_local()
    m = local.detach().amax(-1)
    for d in cut:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", r.mesh.get_group(d).group_name))
    shape = tuple(x.shape[:-1])

    def row(t, pl):
        return DTensor.from_local(t, r.mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_strides(shape))

    s = torch.exp(local - m[..., None]).sum(-1)
    s = _Reduce.apply(row(s, [Partial() if i in cut else p for i, p in enumerate(x.placements)]),
                      r, cut)
    return torch.log(s) + row(m, [Replicate() if i in cut else p
                                  for i, p in enumerate(x.placements)])
