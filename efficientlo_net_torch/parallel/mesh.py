"""Device meshes for data-parallel training and the W-axis ring.

The port's copy of ``efficientlo_net_tpu/parallel/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group (one per device), with a ``data`` dimension, and a ``ring``
dimension when its shape has two.  A global batch is split over ``data`` in
contiguous rows, as ``NamedSharding(mesh, P("data"))`` splits it;
parameters are replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
RING_AXIS = "ring"


def make_mesh(shape: Optional[Sequence[int]] = None, device_type: Optional[str] = None
              ) -> DeviceMesh:
    """A mesh over every process of the default group: shape (world,) named
    ("data",) by default, or (data, ring) named ("data", "ring"); on
    ``"cuda"`` unless ``device_type`` asks for ``"cpu"``."""
    shape = (dist.get_world_size(),) if shape is None else tuple(int(s) for s in shape)
    names = {1: (DATA_AXIS,), 2: (DATA_AXIS, RING_AXIS)}.get(len(shape))
    if names is None:
        raise ValueError(f"a mesh has one (data) or two (data, ring) dimensions, got {shape}")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=names)


def axis_group(mesh, axis: Optional[str] = None):
    """The process group of ``mesh``'s dimension ``axis`` (None: the only
    dimension of a one-dimensional mesh); ``mesh`` may also be a process
    group, returned as it is, or None (no group: one rank)."""
    if isinstance(mesh, DeviceMesh):
        return mesh.get_group(axis)
    return mesh


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's index, the count) along the mesh's data dimension: this
    rank holds the index-th of count contiguous row blocks."""
    if isinstance(mesh, DeviceMesh):
        if DATA_AXIS not in (mesh.mesh_dim_names or ()):
            return 0, 1
        return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    group = axis_group(mesh)
    if group is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors).  Raises
    ``ValueError`` where the batch does not split evenly."""
    index, count = batch_sharding(mesh)
    out = {}
    for key, value in batch.items():
        b = value.shape[0]
        if b % count:
            raise ValueError(f"batch {key!r} of {b} rows does not split over {count} ranks")
        rows = b // count
        out[key] = value[index * rows:(index + 1) * rows]
    return out


def replicated(mesh):
    """The process group over which every rank of ``mesh`` holds the same
    value: the whole mesh (the default group for a mesh of every process)."""
    if isinstance(mesh, DeviceMesh):
        if mesh.ndim == 1:
            return mesh.get_group()
        if mesh.size() != dist.get_world_size():
            raise ValueError("a multi-dimensional mesh must span every process")
        return dist.group.WORLD
    return mesh
