"""Abstract inputs and their layouts for every (arch x shape x mesh) cell.

`input_specs()` returns DTensor stand-ins for every input of the step: each
is `DTensor.from_local` of one rank's shard, a tensor on the `meta` device,
so no memory is ever allocated and no op computes anything.  Each carries its
resolved spec tuple as `.partition_spec`; the dtypes are the JAX package's
(`repro/launch/specs.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell
from repro_torch.launch.mesh import data_axes
from repro_torch.models import transformer as T
from repro_torch.models.params import (ParamDesc, contiguous_strides, default_rules,
                                       local_shape, mesh_shape, placements,
                                       resolve_spec, tree_map_desc)


# ---------------------------------------------------------------------------
# per-cell axis rules
# ---------------------------------------------------------------------------

def axis_rules_for(cfg: ModelConfig, cell: ShapeCell, mesh,
                   overrides: dict[str, Any] | None = None) -> dict[str, Any]:
    multi_pod = "pod" in mesh.mesh_dim_names
    rules = default_rules(multi_pod)
    if cell.kind in ("train", "prefill"):
        # Megatron-style activation sequence sharding between layers
        rules["seq_act"] = "model"
    if cell.kind in ("prefill", "decode"):
        # KV caches: shard the sequence dim over the model axis (frees the
        # kv_heads fallback problem for 20/28-head archs and MLA's headless
        # latent cache).  long_500k (batch=1) uses the data axis instead —
        # sequence-parallel decode.
        rules["kv_seq"] = "data" if cell.name == "long_500k" else "model"
    if overrides:
        rules.update(overrides)
    return rules


def _dt(shape, dtype, mesh, spec: tuple):
    """A DTensor of global `shape` laid out by `spec`, whose local shard is a
    meta tensor."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(shape, spec, mesh_shape(mesh)), dtype=dtype,
                        device="meta")
    t = DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                           shape=torch.Size(shape), stride=contiguous_strides(shape))
    t.partition_spec = spec
    return t


def param_specs(cfg: ModelConfig, mesh, rules) -> Any:
    descs = T.build_descriptors(cfg)
    ms = mesh_shape(mesh)
    pdt = getattr(torch, cfg.param_dtype)

    def mk(d: ParamDesc):
        # parameters keep their declared dtype except float params follow cfg
        dtype = d.dtype if d.dtype is not None else pdt
        if dtype.is_floating_point:
            dtype = pdt
        return _dt(d.shape, dtype, mesh, resolve_spec(d, rules, ms))

    return tree_map_desc(mk, descs)


def opt_rule_extend(spec, shape, ms: dict[str, int], data_axis: str) -> tuple:
    """ZeRO-style: additionally shard optimizer-state tensors over the data
    axis on the largest still-unsharded divisible dim."""
    used = set()
    for s in spec:
        if s is None:
            continue
        used.update((s,) if isinstance(s, str) else s)
    if data_axis in used:
        return tuple(spec)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (dim, s) in enumerate(zip(shape, parts)):
        if s is None and dim % ms.get(data_axis, 1) == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        parts[best] = data_axis
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def opt_specs(cfg: ModelConfig, mesh, rules) -> Any:
    descs = T.build_descriptors(cfg)
    ms = mesh_shape(mesh)

    def mk(d: ParamDesc):
        spec = opt_rule_extend(resolve_spec(d, rules, ms), d.shape, ms, "data")
        return _dt(d.shape, torch.float32, mesh, spec)

    return {"m": tree_map_desc(mk, descs), "v": tree_map_desc(mk, descs)}


def cache_specs(cfg: ModelConfig, mesh, rules, batch: int, seq: int):
    descs = T.build_cache_descriptors(cfg, batch, seq)
    ms = mesh_shape(mesh)

    def mk(d: ParamDesc):
        return _dt(d.shape, d.dtype, mesh, resolve_spec(d, rules, ms))

    return [tree_map_desc(mk, g) for g in descs]


def _batch_spec(mesh, batch: int) -> tuple:
    """(the data axes,) when they divide `batch`, else () (replicated)."""
    da = data_axes(mesh)
    ms = mesh_shape(mesh)
    n = 1
    for a in da:
        n *= ms[a]
    if batch % n:
        return ()
    return (da if len(da) > 1 else da[0],)


def batch_specs(cfg: ModelConfig, mesh, cell: ShapeCell, with_labels: bool):
    B, S = cell.global_batch, cell.seq_len
    bspec = _batch_spec(mesh, B)
    out = {"tokens": _dt((B, S), torch.int32, mesh, bspec)}
    if with_labels:
        out["labels"] = _dt((B, S), torch.int32, mesh, bspec)
    if cfg.enc_dec:
        out["enc_feats"] = _dt((B, cfg.enc_frames, cfg.d_model), torch.float32,
                               mesh, bspec)
    return out


# ---------------------------------------------------------------------------
# full per-cell spec bundles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    cfg: ModelConfig
    cell: ShapeCell
    rules: dict[str, Any]
    args: tuple          # abstract args for the step fn
    kind: str


def input_specs(arch: str, shape: str, mesh, cfg: ModelConfig | None = None) -> CellSpec:
    """The step's abstract args for one cell.  The step and its scalars
    (`step`, `pos_t`) are 0-d int32 DTensors, as the reference's are; the
    step fn of the port takes them as Python ints."""
    cfg = cfg or registry.get_config(arch)
    cell = SHAPES[shape]
    rules = axis_rules_for(cfg, cell, mesh)
    params = param_specs(cfg, mesh, rules)
    scalar = _dt((), torch.int32, mesh, ())
    if cell.kind == "train":
        opt = opt_specs(cfg, mesh, rules)
        batch = batch_specs(cfg, mesh, cell, with_labels=True)
        args = (params, opt, batch, scalar)
    elif cell.kind == "prefill":
        args = (params, batch_specs(cfg, mesh, cell, with_labels=False))
    else:  # decode
        B = cell.global_batch
        caches = cache_specs(cfg, mesh, rules, B, cell.seq_len)
        tokens = _dt((B, 1), torch.int32, mesh, _batch_spec(mesh, B))
        args = (params, caches, tokens, scalar)
    return CellSpec(arch=arch, shape=shape, cfg=cfg, cell=cell, rules=rules,
                    args=args, kind=cell.kind)
