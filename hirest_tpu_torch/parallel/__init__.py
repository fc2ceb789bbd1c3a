from hirest_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    param_shardings,
    replicate,
)
