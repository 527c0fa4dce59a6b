"""Production meshes. Counterpart of ``repro/launch/mesh.py``.

Functions, not module constants: importing this module touches no
process-group or CUDA state. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group the
launcher started (``torch.distributed.init_process_group`` with an address,
the world size and this process's rank); the axis names are the
reference's, ``("data", "model")`` in a pod and ``("pod", "data",
"model")`` across two.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def production_layout(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh: 16x16 = 256 ranks a
    pod; 2 pods for the multi-pod layout."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda") -> DeviceMesh:
    """The :func:`production_layout` mesh. The process group must hold
    exactly that many ranks. On the GPU unless ``device_type="cpu"``."""
    resolve_device(device_type)
    shape, axes = production_layout(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def data_axes(mesh: DeviceMesh) -> tuple:
    """The axes batches shard over (DP): ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def make_host_mesh(*, device_type: str = "cuda") -> DeviceMesh:
    """A (1, 1) ``("data", "model")`` mesh on this process alone, for runs
    on one device. Without a process group it starts one of world size 1
    on an in-process store (NCCL on the GPU, gloo with
    ``device_type="cpu"``)."""
    resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
