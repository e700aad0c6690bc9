"""The port's device mesh: a 1-D "data" axis over the ranks of the default
torch.distributed process group.

The JAX package shards an utterance batch over the devices of one process
(`ssr_eval_tpu/parallel/mesh.py`).  In PyTorch one process drives one card,
so the port's data axis runs across processes: rank r of a group of W owns
`cuda:{LOCAL_RANK or r % device_count}` (or the CPU for device="cpu"), and
the evaluation shards files and the trainer rows of the global batch over
the W ranks.  Without a process group the mesh has one rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ssr_eval_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class DataMesh:
    """shape: {"data": W}; rank: this process's index on the axis; device:
    the device this rank runs on."""

    shape: dict
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape["data"]


def group_rank_and_size() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def rank_device(rank: int, device=None) -> torch.device:
    """The device rank `rank` runs on: the CPU for device="cpu", a card
    named with its index as named, else the card LOCAL_RANK names (the
    launcher's) or rank % the cards visible.  Raises without a card unless
    the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else rank % torch.cuda.device_count())


def data_mesh(device=None) -> DataMesh:
    """The "data" mesh over the default process group's ranks."""
    rank, world = group_rank_and_size()
    return DataMesh({"data": world}, rank, rank_device(rank, device))


def as_data_mesh(mesh, what: str) -> DataMesh | None:
    """`mesh` checked as a keyword of `what`: None or a DataMesh."""
    if mesh is None or isinstance(mesh, DataMesh):
        return mesh
    raise TypeError(
        f"{what}(mesh=...) takes a DataMesh from ssr_eval_tpu_torch.parallel.data_mesh() (one "
        f"process per card, the data axis over the torch.distributed ranks), not {type(mesh).__name__}"
    )


def mesh_device(mesh: DataMesh | None, device=None) -> torch.device:
    """The device of an entry point given `mesh` and `device`: the mesh's,
    which a `device` of another type contradicts."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r} contradicts the mesh's device {mesh.device}")
    return mesh.device


def pad_batch_for_mesh(n: int, mesh: DataMesh | None) -> int:
    """Round a batch size up to a multiple of the data-axis size."""
    if mesh is None:
        return n
    d = mesh.shape["data"]
    return -(-n // d) * d
