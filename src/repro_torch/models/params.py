"""Parameter descriptor system.

A model is described by a tree (nested dicts and lists) of `ParamDesc`
leaves.  The same tree is the single source of truth for

  * initialization          (`init_tree`; `params_from_numpy` loads weights
    made elsewhere in the same layout)
  * sharding specs          (`spec_tree`) and DTensor placements
    (`placement_tree`) on a `DeviceMesh`

Logical axis names on each parameter dim map to mesh axes through a rules
dict (e.g. ``{"ff": "model", "vocab": "model", "batch": ("pod", "data")}``).
A logical axis is only sharded when the dimension size is divisible by the
product of the mesh axis sizes it maps to; otherwise it silently falls back
to replication (this is what makes e.g. 28-head models lay out on a 16-way
model axis).  A spec is a plain tuple with one entry per leading dim:
None, a mesh-axis name, or a tuple of names, trailing Nones stripped, as
the JAX package's `PartitionSpec` reads.
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


# ---------------------------------------------------------------------------
# Sharding: logical axes -> mesh axes -> DTensor placements
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or any object with
    `mesh_dim_names` and `shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh_shape: dict[str, int], mesh_axes) -> int:
    """The total size of the mesh axes a spec entry names (1 for None)."""
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        return mesh_shape.get(mesh_axes, 1)
    return math.prod(mesh_shape.get(a, 1) for a in mesh_axes)


def resolve_axes(shape, axes, rules: dict[str, Any],
                 mesh_shape: dict[str, int]) -> tuple:
    """Logical axes of a `shape` -> spec tuple, with divisibility fallback:
    a dim is left unsharded when its rule maps to nothing, to mesh axes of
    total size 1 or not dividing it, or to a mesh axis an earlier dim took."""
    parts: list = []
    used: set = set()
    for dim, ax in zip(shape, axes):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            parts.append(None)
            continue
        size = axis_size(mesh_shape, mapped)
        names = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        if size <= 1 or dim % size != 0 or any(n in used for n in names):
            parts.append(None)
            continue
        used.update(names)
        parts.append(mapped)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def resolve_spec(d: ParamDesc, rules: dict[str, Any], mesh_shape: dict[str, int]) -> tuple:
    """A descriptor's logical axes -> spec tuple (see `resolve_axes`)."""
    return resolve_axes(d.shape, d.axes, rules, mesh_shape)


def spec_tree(tree, rules: dict[str, Any], mesh):
    ms = mesh_shape(mesh)
    return tree_map_desc(lambda d: resolve_spec(d, rules, ms), tree)


def placements(spec: tuple, mesh) -> list:
    """A spec tuple -> one DTensor placement per mesh dim: `Shard(dim)` on
    each mesh axis that tensor dim `dim` names, `Replicate()` elsewhere (the
    counterpart of the JAX package's `NamedSharding(mesh, spec)`).  A dim
    named by several mesh axes is split over them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for name in ((ax,) if isinstance(ax, str) else ax):
            out[names.index(name)] = Shard(dim)
    return out


def placement_tree(tree, rules: dict[str, Any], mesh):
    ms = mesh_shape(mesh)
    return tree_map_desc(lambda d: placements(resolve_spec(d, rules, ms), mesh), tree)


def local_shape(shape, spec: tuple, mesh_shape: dict[str, int]) -> tuple[int, ...]:
    """The shape of one device's shard of a tensor laid out by `spec`."""
    return tuple(dim // axis_size(mesh_shape, spec[i] if i < len(spec) else None)
                 for i, dim in enumerate(shape))


def contiguous_strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# Default logical-axis -> mesh-axis rules
# ---------------------------------------------------------------------------

def default_rules(multi_pod: bool = False, *, shard_layers_over_data: bool = False,
                  seq_axis: bool = False) -> dict[str, Any]:
    """Baseline tensor-parallel rules.

    batch      -> data (and pod) axes  (pure DP)
    vocab/ff/heads/inner/rnn -> model axis (TP)
    layers     -> optionally data (ZeRO-3-style param sharding)
    seq        -> data (sequence-parallel KV cache for batch=1 long context)
    """
    data_axes = ("pod", "data") if multi_pod else ("data",)
    rules: dict[str, Any] = {
        "batch": data_axes if len(data_axes) > 1 else data_axes[0],
        "vocab": "model",
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "data",        # expert-parallel over the data axis
        "expert_ff": "model",     # + TP inside experts
        "inner": "model",         # mamba d_inner
        "rnn": "model",           # rg-lru width
        "state": None,
        "lora": None,
        "layers": data_axes[-1] if shard_layers_over_data else None,
        "kv_seq": data_axes[-1] if seq_axis else None,
        "seq_act": None,          # activation sequence sharding (train/prefill)
        "frames": None,
    }
    return rules
