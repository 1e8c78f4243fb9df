"""Partitioned heterogeneous-format SpMV.

The paper's run-time mode picks one format for the whole matrix; this
subsystem runs it per row block. ``partitioner`` splits the row range into
nnz-balanced blocks (each with its own Table-2 feature vector), ``plan``
routes every block through the format registry + predictors + cost model
and searches block counts {1, 2, 4, 8} with a monolithic fallback, and
``executor`` runs the winning composite plan — heterogeneous per-block CUDA
kernels on one device, every block fused into ONE launch
(``compile_fused_partitioned``), or one block per device over a mesh
``data`` axis through the ELL carrier (``shard_partitioned``: X copied to
every device, Y shards local).

Session/cache/serving integration lives in ``repro_torch.core.session``
(``partitioned_optimize``), ``repro_torch.core.cache`` (per-block plan
entries), and ``repro_torch.train.serve`` / ``repro_torch.launch.serve``
(``--partition``).
"""

from repro_torch.partition.executor import (
    BlockKernel,
    FusedPartitionedSpmv,
    PartitionedSpmv,
    ShardedPartitionedSpmv,
    compile_fused_partitioned,
    compile_partitioned,
    shard_partitioned,
)
from repro_torch.partition.partitioner import (
    SUPPORTED_BLOCK_COUNTS,
    RowBlock,
    RowPartition,
    partition_rows,
)
from repro_torch.partition.plan import (
    BlockPlan,
    CompositePlan,
    plan_for_partition,
    plan_partitioned,
    route_block,
)

__all__ = [
    "BlockKernel",
    "BlockPlan",
    "CompositePlan",
    "FusedPartitionedSpmv",
    "PartitionedSpmv",
    "RowBlock",
    "RowPartition",
    "SUPPORTED_BLOCK_COUNTS",
    "ShardedPartitionedSpmv",
    "compile_fused_partitioned",
    "compile_partitioned",
    "partition_rows",
    "plan_for_partition",
    "plan_partitioned",
    "route_block",
    "shard_partitioned",
]
