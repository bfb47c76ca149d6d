"""Cross-process alignment: a barrier over the process group.

Counterpart of the JAX package's ``parallel/sync.py``. There the processes
align through the distributed runtime's coordination service, because the
runtime's Gloo rendezvous has a fixed 30 s window. Here the runtime is
``torch.distributed``'s process group: a barrier is ``dist.barrier`` on the
rank's card under NCCL, and ``dist.monitored_barrier`` under gloo, which
names the ranks that did not arrive. The fencing rule is the JAX
package's: put a barrier between a phase whose length differs from process
to process (start-up, a checkpoint that rank 0 alone writes, a shard of
other cost) and the next collective or read of shared files.

Every process group the port creates (``parallel.mesh.init_data_parallel``)
has a finite timeout, ``MULTIBOX_BARRIER_TIMEOUT_S`` seconds (600 by
default, the JAX package's knob and default), so a peer that died fails
the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = float(os.environ.get("MULTIBOX_BARRIER_TIMEOUT_S", 600))


def world_size() -> int:
    """Ranks in the default process group; 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def coordination_barrier(name: str, timeout_s: float = None) -> None:
    """Block until every rank reaches this barrier, or raise (naming the
    barrier) on a timeout or a dead peer. A no-op without a process group
    or with one rank, so call sites need no branches."""
    if world_size() == 1:
        return
    timeout = datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=timeout)
        else:  # NCCL: the group's own timeout bounds it
            dist.barrier(device_ids=[torch.cuda.current_device()])
    except RuntimeError as e:
        raise RuntimeError(
            f"barrier {name!r} failed on rank {dist.get_rank()}: {e}") from e
