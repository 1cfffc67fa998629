"""Device meshes for the port.

A function, never a module-level constant, so importing this module touches
no process group.  Production: 16 x 16 = 256 ranks over ("data", "model");
multi-pod: 2 x 16 x 16 = 512 ranks over ("pod", "data", "model").

The production meshes are built over a *fake* process group
(`init_fake_world`): one process stands in for every rank, collectives do
nothing, and DTensor computes each rank-0 shard's shapes.  This is the
counterpart of the JAX package's 512 placeholder host devices
(``--xla_force_host_platform_device_count``).  The fake backend lives in
`torch.testing._internal.distributed.fake_pg`.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_fake_world(n: int):
    """Make this process rank 0 of a fake world of `n` ranks.

    A fake world of another size is torn down first; a process already in a
    real process group raises rather than reuse it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"this process is already in a {dist.get_backend()!r} process "
                "group; the dry run needs a fake one of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def destroy_fake_world():
    """Tear down the fake world, if this process is in one."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_mesh(shape: tuple, axis_names: tuple, device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` over the first prod(shape) ranks of the
    current process group."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 (or 2 x 16 x 16) over a fake world of as many ranks.

    The mesh's device type is "cpu": the fake world needs no card, and the
    dry run uses only the host."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world(math.prod(shape))
    return make_mesh(shape, axes, "cpu")


def make_local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A (world, 1) mesh with the production axis names over the current
    process group (one card: world 1)."""
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device_type)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
