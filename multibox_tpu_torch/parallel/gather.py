"""Cross-process gather of host-side Python objects.

Counterpart of the JAX package's ``parallel/gather.py``, with its design:
detect and eval are parallel over the batch, so each rank detects its own
record shard on its own card (``DetectionDataset`` shard_index /
shard_count) and the ranks' result lists merge with one logical gather.
An object rides a padded uint8 tensor: two collectives in all (lengths,
then the payload), however many results each rank holds. The tensors sit
on the CPU under gloo and on the rank's card under NCCL.
"""

from __future__ import annotations

import pickle
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist

from multibox_tpu_torch.parallel.sync import coordination_barrier, world_size

# one rank's pickled object must stay below this (the JAX package's bound)
MAX_BYTES = 2**31


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather_objects(obj: Any) -> List[Any]:
    """All-gather one picklable object per rank: ``[obj_of_rank_0, ...,
    obj_of_rank_{N-1}]``, the same list on every rank. Without a process
    group, or with one rank: ``[obj]``, no collective.

    A rank that dies before it reaches this call leaves the others waiting
    at the barrier below until the group's timeout; a long eval that hangs
    near its end usually means a worker crashed: read that worker's log.
    """
    if world_size() == 1:
        return [obj]
    # ranks arrive with their shards' skew: align first (parallel.sync)
    coordination_barrier("allgather_objects")
    payload = np.frombuffer(pickle.dumps(obj), np.uint8)
    if payload.size >= MAX_BYTES:
        raise ValueError(
            f"object pickles to {payload.size} bytes — too large for one "
            "cross-process gather; shard the results (e.g. raise the detect "
            "score threshold or gather in batches)")
    device = _collective_device()
    world = dist.get_world_size()
    size = torch.tensor([payload.size], dtype=torch.int64, device=device)
    sizes = [torch.empty_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    lens = [int(s) for s in sizes]
    padded = torch.zeros(max(lens), dtype=torch.uint8, device=device)
    padded[: payload.size] = torch.from_numpy(payload.copy()).to(device)
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return [pickle.loads(p[:n].cpu().numpy().tobytes()) for p, n in zip(parts, lens)]
