"""Data parallelism over torch.distributed (counterpart of
nerf_mae_tpu/parallel/, its `data` axis; the `[data, space]` grid sharding
is not ported yet). `dryrun` holds the multi-process dry runs and the rank
launcher the tests use."""

from nerf_mae_torch.parallel.mesh import (
    DataMesh,
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    batch_rows,
    count_sum,
    distributed,
    gather_objects,
    is_main,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "DataMesh", "all_reduce_grads", "all_reduce_sum", "barrier", "batch_rows", "count_sum",
    "distributed", "gather_objects", "is_main", "make_mesh", "replicate", "shard_batch",
]
