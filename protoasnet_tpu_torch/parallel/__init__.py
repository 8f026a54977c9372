"""The distributed layer: process group, data mesh, batch helpers and
the ZeRO-3 placement (``mesh.py``)."""

from protoasnet_tpu_torch.parallel.mesh import (  # noqa: F401
    distributed_requested,
    fsdp_param_shardings,
    is_main,
    make_mesh,
    maybe_initialize_distributed,
    rank,
    replicate,
    shard_batch,
    shutdown_distributed,
    world_size,
)
