"""Elastic data-parallel scaling (Falkon DRP applied to training).

The paper's DRP grows/shrinks the executor pool on queue pressure; here the
"pool" is the data-parallel width.  Because the data pipeline is
stateless-addressable and optimizer state is sharded by logical rules,
rescaling between steps is: build the new mesh -> re-resolve the
placements -> `distribute_tensor` (or `redistribute`, for a DTensor) the
state.  The policy object mirrors DRPConfig.  The port of the JAX
package's `repro/distributed/elastic.py`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import (default_rules, is_desc, mesh_shape, placements,
                                       resolve_spec, tree_leaves, tree_map)


@dataclasses.dataclass
class ElasticPolicy:
    min_dp: int = 1
    max_dp: int = 64
    grow_threshold: float = 2.0    # backlog/step-time ratio to grow
    shrink_threshold: float = 0.25

    def decide(self, current_dp: int, backlog: float, step_time: float) -> int:
        ratio = backlog / max(step_time, 1e-9)
        if ratio > self.grow_threshold and current_dp < self.max_dp:
            return min(self.max_dp, current_dp * 2)
        if ratio < self.shrink_threshold and current_dp > self.min_dp:
            return max(self.min_dp, current_dp // 2)
        return current_dp


def make_mesh_for_dp(dp: int, model: int = 1, device_type: str = "cuda"):
    """A (dp, model) mesh over ("data", "model") on the first dp * model
    ranks of the current process group."""
    need = dp * model
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise ValueError(f"need {need} ranks, have {have}")
    return make_mesh((dp, model), ("data", "model"), device_type)


def reshard_tree(tree, descs, mesh, rules=None):
    """Re-place a (possibly differently-sharded) state tree onto `mesh`, each
    leaf onto the placements its descriptor resolves to.  A DTensor on
    `mesh` is redistributed; one on another mesh is gathered whole on that
    mesh's ranks, then, like a plain tensor, distributed from rank 0 of
    `mesh` (a rank outside the old mesh holds nothing to send)."""
    rules = rules or default_rules()
    ms = mesh_shape(mesh)
    descs_of = {id(t): d for t, d in zip(tree_leaves(tree), tree_leaves(descs, is_leaf=is_desc))}

    def one(t):
        pl = placements(resolve_spec(descs_of[id(t)], rules, ms), mesh)
        if isinstance(t, DTensor):
            if t.device_mesh == mesh:
                return t.redistribute(mesh, pl)
            if t.device_mesh.get_coordinate() is not None:
                t = t.full_tensor()
            else:
                t = torch.empty(t.shape, dtype=t.dtype, device=mesh.device_type)
        return distribute_tensor(t, mesh, pl, src_data_rank=0)

    return tree_map(one, tree)
