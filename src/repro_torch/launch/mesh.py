"""Production mesh construction — the port of `repro.launch.mesh`, as a
`torch.distributed` `DeviceMesh`.

The reference's dry run lays its plan over 512 placeholder CPU devices
that stand in for 2 pods x 256 TPU v5e chips
(`src/repro/launch/dryrun.py:1-5`). The port keeps that design: the
mesh's ranks are placeholders of a fake process group (backend
``"fake"`` over a `FakeStore`), and its device type is ``"cpu"``. No
collective moves a byte and nothing is allocated; the plan is checked
and counted, never run. This is the dry run's own design, not a
fallback: the card's serving and training paths never build a mesh.

A FUNCTION, not a module-level constant: importing this module starts
no process group.
"""
from __future__ import annotations

import math

import torch


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks ('data', 'model'); multi_pod adds a leading
    'pod' axis of 2 (512 ranks). Starts the fake process group on first
    use (its world is the mesh's size) and builds the mesh from its
    first ranks; a group too small for the mesh is replaced
    (`_clear_sharding_caches` first)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() < n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        _clear_sharding_caches()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _clear_sharding_caches():
    """Empty DTensor's sharding-propagation caches (native and Python)
    before a new process group starts: an output spec cached on a mesh of
    an earlier group in this process compares equal to the same layout
    on the new group, and would hand back the destroyed group's name to
    the next collective (one process that runs steps on two groups:
    the dry run's CLI over both meshes, the tests)."""
    from torch.distributed.tensor import DTensor
    torch._C._clear_DTensor_sharding_propagator_cache()
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()


def axis_size(mesh, name: str) -> int:
    """Extent of mesh axis `name` (the reference's `mesh.shape[name]`)."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def data_axes(mesh) -> tuple:
    """Axes that shard the batch dimension."""
    names = mesh.mesh_dim_names
    return tuple(a for a in names if a in ("pod", "data"))
