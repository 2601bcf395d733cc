"""Process-group set-up and host-side data sharding.

Port of hidegs_tpu/parallel/distributed.py. The reference is single-process
(SURVEY §2.4/§5.8). For multi-GPU training each process joins one
`torch.distributed` group, feeds only its own share of the cameras, and
the view-parallel step (parallel/sharded.py) reduces the gradients with
explicit collectives. The backend is the caller's choice: NCCL for CUDA by
default, gloo only when the caller asks for the CPU or names it. Nothing
switches backends when one fails: a group that cannot form raises.
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hidegs_tpu_torch.device import DeviceLike, resolve_device


def default_backend(device: DeviceLike) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Join the default process group. Returns False, and does nothing, for
    a single process without an explicit `init_method`.

    Under torchrun the rank, world size and rendezvous come from `RANK`,
    `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` ("env://"); otherwise pass
    `init_method` ("tcp://host:port" or "file:///path"), `world_size` and
    `rank`. An explicit `init_method` forms the group even for one process
    (a one-rank NCCL group). `backend` defaults to `default_backend(device)`.
    On a CUDA device the process binds to `device` (an index, or
    `LOCAL_RANK` modulo the card count when it has none) before the group
    forms; an NCCL group is created eagerly on that card, so a failure
    raises here."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    kwargs = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)  # the card's context, before DeviceMesh looks for one
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return True


def shutdown_distributed():
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_camera_indices(n_cameras: int, seed: int = 0) -> List[int]:
    """Deterministic partition of camera indices across processes: every
    process loads/decodes only its own views (host-side data sharding,
    SURVEY §5.8). The JAX package's partition."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n_cameras)
    return [int(i) for i in order[process_index()::process_count()]]


def state_digest(tensors) -> np.ndarray:
    """The 16 bytes of an MD5 digest of the raw bytes of `tensors`, as
    float32 values 0-255: equal on two ranks iff (but for collisions) every
    tensor is bitwise equal."""
    h = hashlib.md5()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return np.frombuffer(h.digest(), np.uint8).astype(np.float32)


def assert_same_across_hosts(x, name: str = "value", device: DeviceLike = "cpu"):
    """Cheap consistency check for replicated host-side state: the first 16
    values of `x` on every rank within atol 1e-6 of rank 0's (np.allclose's
    rtol 1e-5). `device` is where the gathered copy lives: the backend's
    (the card for NCCL). `state_digest` turns whole tensors into 16 values
    for a bitwise check."""
    if not dist.is_initialized():
        return
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1)[:16].cpu().numpy()
    arr = torch.as_tensor(np.asarray(x, dtype=np.float32).ravel()[:16], device=resolve_device(device))
    gathered = [torch.empty_like(arr) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, arr)
    for g in gathered:
        if not torch.allclose(g, gathered[0], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{name} differs across hosts")
