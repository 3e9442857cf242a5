"""Production meshes — the port of the JAX package's ``launch/mesh.py``.

Functions, not module-level constants: importing this module builds no
mesh and joins no process group. The caller (a rank of its own, or the
dry-run's fake group of 256 or 512 ranks) has joined the default group
first; a mesh takes its ranks in order.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.context import AXES, MULTI_POD_AXES


def _mesh(shape, names, device_type: str) -> DeviceMesh:
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1
    for n in shape:
        need *= n
    if world != need:
        raise ValueError(f"a {shape} mesh needs a process group of {need} ranks, "
                         f"this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: (16, 16) = 256 ranks ('data', 'model').
    Multi-pod: (2, 16, 16) = 512 ranks ('pod', 'data', 'model'). The
    dry-run's fake group lays it out on the host ("cpu")."""
    if multi_pod:
        return _mesh((2, 16, 16), MULTI_POD_AXES, "cpu")
    return _mesh((16, 16), AXES, "cpu")


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str = "cpu") -> DeviceMesh:
    """A small ('data', 'model') mesh over the process group that exists
    (tests, examples, ranks sharing one card)."""
    return _mesh((data, model), AXES, device_type)
