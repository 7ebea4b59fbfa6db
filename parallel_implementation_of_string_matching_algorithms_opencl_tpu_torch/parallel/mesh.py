"""The rank's place in the data-parallel decomposition (counterpart of the
JAX ``parallel/mesh.py``).

The reference is one controller over a 1-D mesh of devices.  Here each
device is driven by its own process, one rank of a ``torch.distributed``
process group, so the "mesh" a rank sees is the group, its own rank and
the world size, and the one device it runs on.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from ..models.base import resolve_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``group``: the process group the collectives run on, or None for a
    world of one rank, which issues no collective.  ``device``: the rank's
    device."""

    group: object
    rank: int
    world: int
    device: torch.device


def rank_device(rank: int) -> torch.device:
    """The CUDA device of ``rank``: ``cuda:{LOCAL_RANK}``, or ``rank %
    device_count`` when ``LOCAL_RANK`` is unset.  Raises without CUDA."""
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def make_data_mesh(group=None, device=None) -> DataMesh:
    """The mesh of this rank: ``group`` (default: the default process group
    when one is initialized), its rank and world size, and ``device``
    (default: ``rank_device(rank)``, which raises without CUDA;
    ``device="cpu"`` runs the kernels' plain versions).

    Without an initialized process group the mesh is a world of one rank and
    no collective is issued: the counterpart of the reference's
    ``make_data_mesh(1)``."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a process group was passed but torch.distributed "
                         "is not initialized")
    else:
        rank, world = 0, 1
    dev = rank_device(rank) if device is None else resolve_device(device)
    return DataMesh(group=group, rank=rank, world=world, device=dev)


def all_gather(out: torch.Tensor, t: torch.Tensor, mesh: DataMesh) -> None:
    """``out`` (``world * t.numel()`` elements, on the mesh's device) gets
    every rank's ``t`` in rank order: one collective, which must be issued
    by every rank of the group."""
    with warnings.catch_warnings():
        # Newer PyTorch names this call all_gather_single; older ones have
        # only this name.
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*all_gather_into_tensor.*")
        dist.all_gather_into_tensor(out, t, group=mesh.group)
