"""Data parallelism over processes: one process a card under
``torch.distributed``, launched by ``torchrun``.

Counterpart of the JAX package's ``parallel/mesh.py``. There one process
drives N devices, and ``jax.jit`` runs the train step over a global batch
sharded on its leading axis: every reduction over the batch is a reduction
over the global batch, and XLA adds the collectives (a derived psum). The
PyTorch idiom is one process a card; this module maps the first onto the
second:

- The global batch is the ranks' local batches concatenated in rank order,
  the order of ``jax.make_array_from_process_local_data``.
- :func:`make_parallel_train_step` runs the port's functional step inside
  :func:`data_parallel`. There the step's reductions over the batch become
  global through explicit collectives: train-mode BatchNorm's statistics
  (``models.inception_v3.SlimBatchNorm``: Σx, Σx² and the count summed
  over the ranks, their gradients summed in the backward), the loss's
  normaliser and logged metrics (``train.loss.multibox_loss``) and the
  gradients (``train.state.make_train_step``: a SUM, one collective a
  dtype, before the optimizer, so gradient clipping sees the global
  norm). Augmentation draws its parameters for the global batch and keeps
  the rank's rows; gradient-accumulation microbatches are slices of the
  global batch.
- ``DistributedDataParallel`` does not apply: the step is functional (the
  parameters are a dict, the gradients come from ``torch.autograd.grad``),
  DDP hooks ``.backward()`` on a module's parameters, and it averages the
  gradients where each rank's loss is its rows' share of the global loss,
  whose gradient is their sum.
- The counterpart of ``make_parallel_detect_fn`` is one detect loop a rank
  over its record shard, merged by one gather
  (``inference.run_detect_loop``).

Without a process group, or with one rank, nothing here issues a
collective, and the step is the one-process step bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import logging
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.parallel.sync import DEFAULT_TIMEOUT_S, world_size

log = logging.getLogger(__name__)


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def init_data_parallel(backend: Optional[str] = None, device=None,
                       timeout_s: Optional[float] = None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns whether a group is up. Without that
    environment nothing happens (one process).

    ``backend=None`` is NCCL on the rank's card: ``device`` when the caller
    names a CUDA device, else ``cuda:LOCAL_RANK``; it raises without CUDA.
    gloo runs only when asked for (``backend="gloo"``), or when ``device``
    names the CPU. NCCL refuses two ranks on one card, so two ranks that
    share a card name it and ask for gloo, which carries CUDA tensors. The
    group's timeout is ``timeout_s`` (``MULTIBOX_BARRIER_TIMEOUT_S``, 600 s,
    by default), so a hung peer fails the run."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "WORLD_SIZE" not in env or "RANK" not in env:
        return False
    world, rnk = int(env["WORLD_SIZE"]), int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rnk))
    named = torch.device(device) if device is not None else None
    if backend is None:
        backend = "gloo" if named is not None and named.type == "cpu" else "nccl"
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_data_parallel: NCCL needs a CUDA device and there "
                               "is none; pass backend='gloo' for the CPU")
        card = named if named is not None and named.type == "cuda" else \
            torch.device("cuda", local)
        index = card.index if card.index is not None else local
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_data_parallel: rank {rnk} wants CUDA device {index}, but there "
                f"are {torch.cuda.device_count()}")
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(
        backend, rank=rnk, world_size=world,
        timeout=datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s),
        **kwargs)
    log.info("rank %d of %d joined the %s group", rnk, world, backend)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis as this process sees it: its rank, the number of
    ranks and its device."""
    rank: int
    size: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """This process's place on the data axis (one process without a
    group); ``device=None`` is the rank's card (``resolve_device``)."""
    return Mesh(rank(), world_size(), resolve_device(device))


def shard_batch(batch: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The rank's local rows of a batch (numpy or tensors) on its device,
    copied asynchronously: the counterpart of ``put_host_local``. Each rank
    reads only its own records (``DetectionDataset`` shard_index /
    shard_count), so the global batch is never assembled anywhere."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# the data-parallel region and its collectives
# --------------------------------------------------------------------------

# set within data_parallel(); a context variable, so that another thread
# (a prefetcher, a server's worker) never sees this thread's region
_in_region: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "multibox_data_parallel", default=False)

# Collectives issued, by kind; with timing on, CUDA events around each one
# on CUDA tensors (read with collective_ms).
COLLECTIVES: Dict[str, int] = {"batch_norm": 0, "loss": 0, "gradients": 0,
                               "broadcast": 0}
_events: Optional[Dict[str, list]] = None


@contextlib.contextmanager
def data_parallel():
    """Within the block, and under a group of more than one rank, the train
    step's reductions over the batch are global (:func:`reducing`)."""
    token = _in_region.set(True)
    try:
        yield
    finally:
        _in_region.reset(token)


def reducing() -> bool:
    """Whether reductions over the batch are global here: inside
    :func:`data_parallel` with more than one rank."""
    return _in_region.get() and world_size() > 1


def global_rows(local: int):
    """``(first row, global batch)`` of this rank's ``local`` rows in the
    global batch when :func:`reducing`, else ``None``."""
    if not reducing():
        return None
    return rank() * local, local * world_size()


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def time_collectives(on: bool) -> None:
    """Record CUDA events around every collective on CUDA tensors from now
    on (``on``), or stop and drop them."""
    global _events
    _events = {k: [] for k in COLLECTIVES} if on else None


def collective_ms() -> Dict[str, float]:
    """Device ms spent in each kind of collective since timing began
    (synchronizes)."""
    if _events is None:
        return {}
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in pairs) for k, pairs in _events.items()}


def _collective(kind: str, fn, t: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    if _events is None or not t.is_cuda:
        fn(t)
        return
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(t)
    end.record()
    _events[kind].append((start, end))


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place, without gradient; returns it."""
    _collective(kind, dist.all_reduce, t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradient over
    the ranks: each rank's share of a global sum feeds every rank's
    loss."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), kind)

    @staticmethod
    def backward(ctx, g):
        # every rank issues this collective: an unused output's gradient
        # arrives as zeros (materialized), never as a skipped call
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.kind), None


def all_reduce_sum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x, kind)


def _flat_groups(tensors: Iterable[torch.Tensor]):
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


@torch.no_grad()
def _flat_collective(tensors: Iterable[torch.Tensor], kind: str, fn) -> None:
    """Run ``fn`` in place on one flat buffer a dtype holding all of
    ``tensors``, then copy the result back into them."""
    for group in _flat_groups(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        _collective(kind, fn, flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_tensors(tensors: List[torch.Tensor], kind: str) -> None:
    """Sum every tensor over the ranks in place: one collective a dtype."""
    _flat_collective(tensors, kind, dist.all_reduce)


def _leaves(tree: Dict):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield tree, k, v


def replicate_state(state):
    """Broadcast every tensor of a ``TrainState`` (params, batch_stats,
    optimizer state, EMA) and its step counts from rank 0, in place. The
    JAX package relies on equal seeds; the broadcast makes the replicas
    equal whatever the ranks' initialization did. One rank: unchanged."""
    if world_size() == 1:
        return state
    tree = state.to_dict()
    leaves = list(_leaves(tree))
    tensors = [v for _, _, v in leaves if isinstance(v, torch.Tensor)]
    ints = [(d, k) for d, k, v in leaves if isinstance(v, int)]
    counts = torch.tensor([d[k] for d, k in ints], dtype=torch.int64,
                          device=tensors[0].device if dist.get_backend() == "nccl"
                          else "cpu")
    _flat_collective(tensors + [counts], "broadcast", lambda t: dist.broadcast(t, 0))
    for (d, k), v in zip(ints, counts.tolist()):
        d[k] = int(v)
    state.step = tree["step"]
    return state


def make_parallel_train_step(step_fn):
    """The train step over the global batch: ``step_fn`` (from
    ``train.loop.make_augmented_train_step`` or
    ``train.state.make_train_step``) run inside :func:`data_parallel`. Each
    rank passes its local rows; the replicated state comes out equal on
    every rank."""

    def step(state, batch):
        with data_parallel():
            return step_fn(state, batch)

    return step
