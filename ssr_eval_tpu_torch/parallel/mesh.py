"""The port's device meshes over the ranks of the default torch.distributed
process group: `data_mesh()`, a 1-D "data" axis, and `device_mesh(tp)`,
the trainer's 2-D "data" x "model" mesh.

The JAX package shards an utterance batch over the devices of one process
(`ssr_eval_tpu/parallel/mesh.py`).  In PyTorch one process drives one card,
so the port's data axis runs across processes: rank r of a group of W owns
`cuda:{LOCAL_RANK or r % device_count}` (or the CPU for device="cpu"), and
the evaluation shards files and the trainer rows of the global batch over
the W ranks.  Without a process group the mesh has one rank.

The 2-D mesh lays rank = d * tp + m out as dp rows of tp model ranks (the
JAX package's `np.asarray(devices).reshape(dp, tp)`), and holds this
rank's two sub-groups from `dist.new_group`: "data" (the dp ranks that
share its m) and "model" (the tp ranks that share its d).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ssr_eval_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class DataMesh:
    """shape: {"data": W} (or {"data": dp, "model": tp}); rank: this
    process's rank in the default group; device: the device this rank runs
    on; groups: this rank's sub-group per axis (an axis without one runs
    its collectives on the default group)."""

    shape: dict
    rank: int
    device: torch.device
    groups: dict = field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        """Ranks on the "data" axis."""
        return self.shape["data"]

    @property
    def tp(self) -> int:
        """Ranks on the "model" axis (1 for a data mesh)."""
        return self.shape.get("model", 1)

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp


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


def device_mesh(tp: int = 1, device=None) -> DataMesh:
    """The "data" x "model" mesh over the default process group's ranks
    (see the module docstring); every rank must call it, in the same
    order, since each `dist.new_group` is collective.  A world size that
    tp does not divide raises ValueError."""
    rank, world = group_rank_and_size()
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide the process group's {world} rank(s)")
    dp = world // tp
    groups = {}
    if dist.is_available() and dist.is_initialized():
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                groups["data"] = g
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                groups["model"] = g
    return DataMesh({"data": dp, "model": tp}, rank, rank_device(rank, device), groups)


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
