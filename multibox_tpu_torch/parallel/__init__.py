"""Data parallelism: one process a card under ``torch.distributed``, the
train step over the global batch, the detect results gathered.

The JAX package's ``make_parallel_detect_fn`` has no function here: its
counterpart is ``inference.run_detect_loop`` under a group, one detect
loop a rank over its record shard, merged by one gather.
"""

from multibox_tpu_torch.parallel.gather import process_allgather_objects
from multibox_tpu_torch.parallel.mesh import (
    init_data_parallel,
    make_mesh,
    make_parallel_train_step,
    replicate_state,
    shard_batch,
)
from multibox_tpu_torch.parallel.sync import coordination_barrier

__all__ = [
    "coordination_barrier",
    "init_data_parallel",
    "make_mesh",
    "make_parallel_train_step",
    "process_allgather_objects",
    "replicate_state",
    "shard_batch",
]
