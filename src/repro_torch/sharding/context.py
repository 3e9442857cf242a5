"""The ambient device mesh — the port of the JAX package's
``sharding/context.py``.

``launch.workloads.make_workload`` (and a caller that runs ranks of its
own) sets it before the step runs; layers that make collectives of their
own (the MoE's all-to-all form) read it. ``None`` means one process: every
layer takes its unsharded path.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are ``("data", "model")`` or ``("pod", "data",
"model")``, as the reference's axis names are.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")

_MESH: Optional[DeviceMesh] = None


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    if mesh is not None and mesh.mesh_dim_names not in (AXES, MULTI_POD_AXES):
        raise ValueError(f"mesh dims must be named {AXES} or {MULTI_POD_AXES}, "
                         f"got {mesh.mesh_dim_names}")
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[DeviceMesh]:
    return _MESH


def batch_axes() -> Tuple[str, ...]:
    """The mesh dims the batch is split over: ``("pod", "data")`` on a
    multi-pod mesh, ``("data",)`` else, ``()`` without a mesh."""
    return () if _MESH is None else batch_axes_of(_MESH)


def batch_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_rows(h):
    """``h`` (B, ...) with its batch over the batch axes (when it divides
    them) and the rest whole on every ``model`` rank: where the reference's layers leave the
    residual stream, and what the Mamba2 mixer takes its projection as. A
    plain tensor (one process) is returned as it is."""
    if not isinstance(h, DTensor):
        return h
    mesh = h.device_mesh
    batch = batch_axes_of(mesh)
    if h.shape[0] % math.prod(axis_size(mesh, a) for a in batch):
        batch = ()  # a batch too small to split (long-context decode): whole everywhere
    want = tuple(Shard(0) if a in batch else Replicate() for a in mesh.mesh_dim_names)
    return h if tuple(h.placements) == want else h.redistribute(mesh, want)
