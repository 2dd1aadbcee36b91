"""Device meshes on ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``: the same shapes and axis
names, ``(16, 16)`` ``("data", "model")``, ``(2, 16, 16)`` ``("pod",
"data", "model")`` and the coded runtime's ``(n,)`` ``(axis,)``, as
``DeviceMesh``es over the default process group.

The caller initialises the group and chooses its backend: NCCL for one
rank per card; gloo for tests on the CPU and for ranks that share one card
(NCCL refuses two ranks on one device, so a worker mesh on a single H100
is gloo over CUDA tensors: a test topology, not a deployment); ``fake``
(``torch.testing._internal.distributed.fake_pg``) for layouts without
devices.  There is no fallback: without a group, or with a group whose
world size is not the mesh's size, the builders raise, as JAX raises when
it lacks the devices.

Functions, never module-level meshes, so that importing this module
touches no process group.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_worker_mesh", "FSDP_AXES", "BATCH_AXES"]

# logical groupings used by launch/sharding.py
FSDP_AXES = ("pod", "data")     # parameter-sharding (FSDP/ZeRO-3) axes
BATCH_AXES = ("pod", "data")    # activation batch axes


def _make_mesh(shape: Sequence[int], names: Sequence[str],
               device_type: Optional[str]) -> DeviceMesh:
    size = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} ranks; there is no "
                         "initialised process group (0 ranks): call "
                         "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} ranks; the process "
                         f"group has {world}")
    backend = dist.get_backend()
    if backend == "nccl":
        if device_type not in (None, "cuda"):
            raise ValueError(f"an NCCL group's mesh is on cuda, not {device_type!r}")
        device_type = "cuda"
    elif device_type is None:
        device_type = "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16×16 single pod (256 ranks) or 2×16×16 multi-pod (512 ranks).

    ``device_type``: ``cuda`` under NCCL (the default there); under gloo or
    ``fake`` the caller's choice, ``cpu`` by default."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_worker_mesh(n_workers: int, axis: str = "workers",
                     device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh for the coded-computing runtime (n coded workers, one rank
    each); ``device_type`` as for :func:`make_production_mesh`, e.g.
    ``"cuda"`` for gloo ranks that share one card."""
    return _make_mesh((n_workers,), (axis,), device_type)
