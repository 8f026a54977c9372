"""The distributed layer: process group, the data and (data, model)
meshes, batch helpers, the ZeRO-3 placement and prototype tensor
parallelism (``mesh.py``)."""

from protoasnet_tpu_torch.parallel.mesh import (  # noqa: F401
    distributed_requested,
    fsdp_param_shardings,
    is_main,
    make_mesh,
    make_mesh_2d,
    maybe_initialize_distributed,
    prototype_param_shardings,
    rank,
    replicate,
    shard_batch,
    shutdown_distributed,
    world_size,
)
