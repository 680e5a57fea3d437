"""Device meshes on ``torch.distributed``.

Port of ``src/repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh``) over
the ranks of the default process group, which the caller sets up first
(``init_process_group``; ``init_file_group`` does it over a ``FileStore``,
no sockets). ``make_production_mesh`` is a function, never a module-level
constant, so importing this module touches no device or process group.

Axes:
  * ``data``  — batch / FSDP axis (16-way per pod)
  * ``model`` — tensor/expert-parallel axis (16-way, within a node)
  * ``pod``   — multi-pod data-parallel axis; gradients all-reduce across it

Meshes run on CUDA unless the caller asks for ``device="cpu"`` (gloo
process groups, the CPU tests), and raise when there is neither.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def mesh_device_type(device=None) -> str:
    """"cuda" unless ``device`` asks for the CPU; raises with no card."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo "
                           "mesh on the CPU")
    return "cuda"


def init_file_group(store_path: str, rank: int, world_size: int,
                    device=None) -> None:
    """The default process group over a ``FileStore`` at ``store_path``:
    NCCL on the card, gloo on the CPU. Each rank calls it with its own
    ``rank``; on the card rank r uses ``cuda:r``."""
    dev = mesh_device_type(device)
    if dev == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None,
              ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the mesh's size (e.g. a 1 x 1
    mesh on one card); with ``ranks``, over those global ranks only (a
    shrunken mesh: every rank of the group calls it, and a rank outside it
    gets a mesh it has no coordinate in)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(init_process_group / init_file_group)")
    if ranks is not None:
        if len(ranks) != math.prod(shape):
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                             f"got {len(ranks)}")
        return DeviceMesh(mesh_device_type(device),
                          torch.tensor(list(ranks)).reshape(shape),
                          mesh_dim_names=axes)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(device), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) ``("data", "model")`` or,
    multi-pod, (2, 16, 16) ``("pod", "data", "model")``; raises unless the
    process group has 256 or 512 ranks to match."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def axis_names(mesh) -> tuple:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def data_axes(mesh) -> tuple:
    """Axes over which the batch is sharded (pod joins data when present)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def fsdp_axis(mesh) -> str:
    return "data"


def model_axis(mesh) -> str:
    return "model"
