"""Device mesh for multi-GPU training.

Port of hidegs_tpu/parallel/mesh.py. A ("data", "model") mesh over the
ranks of the default process group: the data dimension splits the training
views (each rank renders and differentiates its own views of the same
state), the model dimension can split the gaussian rows. The mesh is a
`torch.distributed.device_mesh.DeviceMesh`; its dimension groups carry the
explicit collectives of parallel/sharded.py. The step works on plain
tensors, not DTensors: the blend kernels are ctypes calls inside autograd
Functions, which DTensor's operator dispatch does not know. `replicated`,
`view_sharded` and `gaussian_sharded` name the three placements the step
uses, as DTensor placements per mesh dimension.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    model: int = 1,
    axis_names: Sequence[str] = AXES,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A (data, model) mesh over the first `n_devices` ranks of the default
    process group (all of them by default), rank r at (r // model, r %
    model). The group must be up (parallel/distributed.py)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    n = dist.get_world_size() if n_devices is None else n_devices
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    ranks = torch.arange(n, dtype=torch.int32).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def replicated(mesh: DeviceMesh) -> Tuple:
    """Every rank holds the whole tensor."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def view_sharded(mesh: DeviceMesh) -> Tuple:
    """A leading per-view batch axis split over the data dimension."""
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def gaussian_sharded(mesh: DeviceMesh) -> Tuple:
    """The gaussian (capacity) axis split over the model dimension."""
    return tuple(Shard(0) if name == "model" else Replicate() for name in mesh.mesh_dim_names)
