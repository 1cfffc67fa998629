"""Parameter descriptor system.

A model is described by a tree (nested dicts and lists) of `ParamDesc`
leaves.  The same tree drives initialization (`init_tree`) and, through
`params_from_numpy`, the loading of weights made elsewhere.

The JAX package also derives sharding specs from the logical axis names
(`spec_tree`, `sharding_tree`, `resolve_spec`) and pins activation layouts
with `distributed.sharding.constrain`.  One card has no mesh, so the port has
no counterpart of either: the axis names are kept only as documentation, and
the `constrain` calls of the model code are dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical axis name (str) or None, per dim
    dtype: torch.dtype | None = torch.float32
    init: str = "normal"  # normal | zeros | ones | lru_a
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    f32: bool = False  # the model reads it in f32: stored in f32 in any compute dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def tree_map(fn: Callable[..., Any], tree, *rest, is_leaf=None):
    """Map `fn` over the leaves of nested dicts/lists/tuples (None stays None).

    `rest` are trees of the same structure whose leaves are passed alongside.
    """
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """Leaves in a deterministic order (dict keys sorted, as JAX orders them)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    if tree is None:
        return []
    return [tree]


def tree_map_desc(fn: Callable[[ParamDesc], Any], tree):
    return tree_map(fn, tree, is_leaf=is_desc)


def stack_desc(tree, n: int, axis_name: str | None = "layers"):
    """Add a leading stacking dim (one slice per repeat of a layer group)."""

    def f(d: ParamDesc) -> ParamDesc:
        return dataclasses.replace(d, shape=(n,) + d.shape, axes=(axis_name,) + d.axes)

    return tree_map_desc(f, tree)


def _fan_in(shape: tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    # last dim is the output dim by convention here
    return max(1, math.prod(shape[:-1]))


def init_tree(tree, generator: torch.Generator, device, dtype: torch.dtype | None = None):
    """Materialize parameters from descriptors on `device`.

    Values are drawn in float32 from `generator` (which must live on
    `device`), leaf by leaf in `tree_leaves` order.  With `dtype`, every
    floating leaf is stored in that dtype, except those marked `f32`: the
    model casts a weight to the compute dtype at use, so storing it once in
    that dtype rounds the same way and halves the memory, while a leaf that
    the JAX package reads in f32 (norm scales, Mamba's `A_log`, the RG-LRU's
    `a_param`) keeps f32 so that it is not rounded.
    """
    device = torch.device(device)

    def init_one(d: ParamDesc):
        out_dtype = d.dtype if d.dtype is not None else torch.float32
        if dtype is not None and out_dtype.is_floating_point and not d.f32:
            out_dtype = dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=out_dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=out_dtype, device=device)
        if d.init == "lru_a":
            # the RG-LRU's Lambda: a = sigmoid(Lambda) ** c with a drawn in
            # (0.9, 0.999), so sigmoid(Lambda) = a ** (1/c) with c = 8
            a = torch.rand(d.shape, generator=generator, device=device) * 0.099 + 0.9
            root = a ** (1.0 / 8.0)
            return torch.log(root / (1 - root)).to(out_dtype)
        if d.init != "normal":
            raise ValueError(f"unknown init {d.init!r}")
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(_fan_in(d.shape))
        x = torch.randn(d.shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(out_dtype)

    leaves = {id(d): init_one(d) for d in tree_leaves(tree, is_leaf=is_desc)}
    return tree_map_desc(lambda d: leaves[id(d)], tree)


def params_from_numpy(tree, device):
    """Numpy arrays (e.g. the JAX package's `init_tree` output, converted by
    the caller) -> tensors on `device`, in the same nested layout.

    The layout is the reference's: layer groups stacked along a leading
    `reps` dim, the same key names (``blocks[g]["l0"]["mixer"]["wq"]``, ...).
    Every array keeps its dtype.
    """
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def count_params(tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(tree, is_leaf=is_desc))
