"""Device meshes and multi-process batching.

Port of ``matrix_inversion_tpu/parallel/``: batches of independent
inversions shard over a ``data`` axis of cards (K1 once per card on its
shard, no collectives), the n*n cells over a ``cell`` axis in the
cell-parallel stage, and processes join a ``torch.distributed`` group
(NCCL where a card is visible, else gloo) in which each inverts its
slice of the global batch.
"""

from .distributed import global_batch_arrays, host_local_slice, initialize_distributed
from .mesh import (
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    ShardedProgram,
    cell_sharded_pipeline,
    data_parallel_inverse,
    data_parallel_inverse_fused,
    make_mesh,
    sharded_inverse_with_stats,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardedProgram",
    "cell_sharded_pipeline",
    "data_parallel_inverse",
    "data_parallel_inverse_fused",
    "global_batch_arrays",
    "host_local_slice",
    "initialize_distributed",
    "make_mesh",
    "sharded_inverse_with_stats",
]
