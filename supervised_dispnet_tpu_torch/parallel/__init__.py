"""Data-parallel training over processes, and spatial partitioning of the
image height (``spatial.py``): the port of ``supervised_dispnet_tpu/parallel``,
its data and spatial axes."""

from supervised_dispnet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    active_mesh,
    all_reduce_max,
    all_reduce_sum,
    average_gradients,
    choose_backend,
    global_mean,
    global_sums,
    init_from_env,
    make_mesh,
    shard_batch,
    spatial_size,
    use_mesh,
)

__all__ = ["DATA_AXIS", "SPATIAL_AXIS", "Mesh", "active_mesh", "all_reduce_max",
           "all_reduce_sum", "average_gradients", "choose_backend", "global_mean",
           "global_sums", "init_from_env", "make_mesh", "shard_batch", "spatial_size",
           "use_mesh"]
