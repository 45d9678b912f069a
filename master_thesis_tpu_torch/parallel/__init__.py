"""Data and sequence parallelism over a ``(data, model)`` mesh of
``torch.distributed`` processes (master_thesis_tpu/parallel)."""

from master_thesis_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_grads,
    barrier,
    broadcast_params,
    global_sum,
    init_distributed,
    launched_world_size,
    make_mesh,
    mesh_shape,
    reducer,
    ref_slice,
    shard_batch,
    sum_scalars,
)
