"""Data and grid parallelism over torch.distributed (counterpart of
nerf_mae_tpu/parallel/: its `data` axis, and its `space` axis, the voxel
grid sharded in slabs, in `spatial`). `dryrun` holds the multi-process dry
runs and the rank launcher the tests use."""

from nerf_mae_torch.parallel.mesh import (
    DataMesh,
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    batch_rows,
    check_token_grid,
    count_sum,
    distributed,
    gather_objects,
    grid_slab,
    host_slab,
    is_main,
    is_spatial,
    make_mesh,
    prepare_spatial_config,
    replicate,
    shard_batch,
)

__all__ = [
    "DataMesh", "all_reduce_grads", "all_reduce_sum", "barrier", "batch_rows",
    "check_token_grid", "count_sum", "distributed", "gather_objects", "grid_slab", "host_slab",
    "is_main", "is_spatial", "make_mesh", "prepare_spatial_config", "replicate", "shard_batch",
]
