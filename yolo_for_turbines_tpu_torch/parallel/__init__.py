"""Data parallelism and spatial partitioning over torch.distributed
(counterpart of ``yolo_for_turbines_tpu/parallel``): ``mesh.py`` (meshes of
ranks, batch placement), ``spatial.py`` (row sharding with halos, the
layout policy) and ``comm.py`` (the collectives, their gradients and the
synced batch norm)."""

from .mesh import (
    DATA_AXIS,
    DCN_AXIS,
    Mesh,
    batch_sharding,
    create_mesh,
    create_multislice_mesh,
    pad_batch_to_multiple,
    replicated_sharding,
    shard_batch,
)
from .spatial import (
    MIN_ROWS_PER_SHARD,
    SPACE_AXIS,
    create_spatial_mesh,
    row_constraint,
    shard_spatial_batch,
    spatial_image_sharding,
    spatial_target_sharding,
)
