"""Data parallelism over ``torch.distributed`` (``mesh.py``) and its
multi-rank dry runs (``dryrun.py``)."""

from .mesh import (batch_sharding, data_parallel_jit, make_mesh,
                   process_allgather, replicate, replicated_sharding,
                   shard_batch)

__all__ = [
    "batch_sharding", "data_parallel_jit", "make_mesh", "process_allgather",
    "replicate", "replicated_sharding", "shard_batch"
]
