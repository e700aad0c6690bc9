"""Multi-process sweeps: process-group set-up, file sharding, the result
gather and coordinator-only reporting.

One process per card (or per CPU worker).  Each process calls

    from ssr_eval_tpu_torch.parallel.multihost import init_distributed
    init_distributed("localhost:29500", num_processes, process_id)   # NCCL
    helper = SSR_Eval_Helper(..., mesh=data_mesh())
    result = helper.evaluate(multihost=True)

and `evaluate` shards the file list round-robin (`shard_paths`), scores its
shard into its own journal, gathers every rank's per-file metrics to every
rank (`gather_results_to_coordinator`) and writes the results JSON on rank
0 only.  torch.distributed needs the coordinator's address, the process
count and this process's index given explicitly: nothing here reads a
cluster's environment.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from ssr_eval_tpu_torch.parallel.mesh import group_rank_and_size, rank_device

TIMEOUT = timedelta(seconds=600)


def init_distributed(coordinator_address: str, num_processes: int, process_id: int, device=None,
                     timeout: timedelta = TIMEOUT):
    """Join the default process group: NCCL on the card (device None), gloo
    for device="cpu".  coordinator_address is "host:port" or a URL
    ("tcp://host:port").  On the card the rank's device becomes the current
    one before any collective (NCCL's object collectives stage through
    it).  -> this rank's device."""
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=url,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=timeout,
    )
    return dev


def is_coordinator() -> bool:
    return group_rank_and_size()[0] == 0


def gather_results_to_coordinator(local_results: dict) -> dict:
    """All-gather every rank's {path: {key: metrics}} dict to every rank and
    merge them one level deep: a file's spec keys may come from several
    ranks (resume journals written under another sharding); in a plain run
    the paths are disjoint and the merge is an update.  One process: the
    merge of its own dict (through the group's collective when there is a
    group, even of one rank)."""
    gathered = [local_results]
    if dist.is_available() and dist.is_initialized():
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local_results)
    merged: dict = {}
    for part in gathered:
        for path, keys in part.items():
            merged.setdefault(path, {}).update(keys)
    return merged


def shard_paths(paths, process_id=None, num_processes=None):
    """Deterministic round-robin file shard for this rank."""
    rank, world = group_rank_and_size()
    pid = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    return list(paths)[pid::n]
