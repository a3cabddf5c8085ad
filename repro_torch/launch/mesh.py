"""Production and host meshes as ``torch.distributed`` ``DeviceMesh``es.

Port of the JAX package's ``launch/mesh.py``.  Functions, not module
constants: importing this module touches no process group.  The caller
initialises the default process group first, at the mesh's world size:
the dry run uses the ``fake`` backend (one process standing for every
rank), a run on cards ``nccl``.
"""
from __future__ import annotations

import torch.distributed as dist


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names): 16x16 single pod (256 chips) or 2x16x16 multi
    pod (512 chips)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {shape} mesh needs a process group of world "
                           f"size {n} (have {have})")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16x16 ("data", "model") or 2x16x16 ("pod", "data", "model")
    mesh over the default process group (world size 256 or 512)."""
    return _mesh(*production_shape(multi_pod), device_type)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """("data", "model") over the ranks of the default process group (one
    a card): data = world size // model_axis."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    data = max(1, n // model_axis)
    return _mesh((data, model_axis), ("data", "model"), device_type)
