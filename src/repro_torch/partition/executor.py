"""Composite execution of a partitioned plan.

* ``PartitionedSpmv`` — each block's format-specific CUDA kernel (compiled
  through the ``FormatSpec`` registry and the process-wide kernel memo,
  keyed per row range) runs in sequence and the per-block outputs
  concatenate back into ``y`` on the device. Formats are fully
  heterogeneous — this is the paper's run-time mode, per block.

* ``FusedPartitionedSpmv`` — the same composite lowered to one flat stream
  and run as ONE launch of the fused kernel (``repro_torch.kernels.fused``).

* ``ShardedPartitionedSpmv`` — multi device. Row blocks map one-per-device
  onto a local mesh's ``data`` axis (``dist.sharding.spmv_mesh``). The
  reference runs one SPMD program on every device, so it executes through a
  homogeneous *carrier* format (ELL planes, padded to a common per-block
  geometry and stacked on a leading "blocks" axis); the port keeps that
  carrier and runs the ELL kernel (B2, ``kernels/ell.py: ell_spmv``) on
  each device, on that device's current stream. The nnz-balanced partition
  is what keeps the per-device work even. Placement follows
  ``repro_torch.dist.sharding.SPMV_RULES``: the blocks axis shards over
  ``data``, X is copied (replicated) to every device, and each Y shard
  stays on the device that computed it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Hashable

import numpy as np
import torch

from repro_torch.dist.sharding import SPMV_RULES, spec_for as sharding_spec, spmv_mesh
from repro_torch.kernels.common import DEFAULT_SCHEDULE, KernelSchedule, ceil_to, pad_axis
from repro_torch.kernels.ell import ell_spmv
from repro_torch.kernels.ops import PreparedSpmv, compile_spmv_block
from repro_torch.obs.trace import span as _span
from repro_torch.partition.partitioner import RowPartition
from repro_torch.partition.plan import CompositePlan
from repro_torch.sparse.registry import get_format
from repro_torch.utils.logging import get_logger

log = get_logger("partition.executor")

CARRIER_FORMAT = "ell"  # dense-plane storage: stackable + shardable


def _wait(device: torch.device) -> None:
    """Block until the device has finished the work queued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass(frozen=True)
class BlockKernel:
    """One row block's prepared kernel, with enough identity to observe."""

    index: int
    row_start: int
    row_end: int
    fmt: str
    kernel: PreparedSpmv


class PartitionedSpmv:
    """Heterogeneous-format composite SpMV on one device.

    Calls each block's ``PreparedSpmv`` and concatenates the outputs in row
    order with ``torch.cat`` on the device. ``timed_call`` additionally
    returns per-block wall times so the serving layer can feed every
    (block, format) arm its own measurement.
    """

    def __init__(self, blocks: list[BlockKernel], n_rows: int):
        if not blocks:
            raise ValueError("PartitionedSpmv needs at least one block")
        self.blocks = list(blocks)
        self.n_rows = n_rows
        self._warmed = False

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def formats(self) -> tuple[str, ...]:
        return tuple(b.fmt for b in self.blocks)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].kernel.device

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()

    def __call__(self, x) -> torch.Tensor:
        x = self._x(x)
        with _span(
            "kernel.execute",
            mode="partitioned",
            n_blocks=self.n_blocks,
            formats="+".join(self.formats),
        ):
            parts = [b.kernel(x) for b in self.blocks]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

    def timed_call(
        self, x, *, warmup: bool = True
    ) -> tuple[np.ndarray, list[float]]:
        """Execute block-by-block, timing each kernel — the measurement feed
        for per-block telemetry arms.

        The first ever call runs every block once untimed (``warmup``):
        without it the first sample's window includes the kernel library's
        load (and build, in a fresh checkout), often orders of magnitude
        above steady state, and that poisoned sample would seed the bandit
        arms and the drift detector. Each window opens and closes on a
        device synchronise, so it covers only that block's kernel, not the
        copy of its output to the host."""
        x = self._x(x)
        dev = self.device
        if warmup and not self._warmed:
            for b in self.blocks:
                b.kernel(x)
            _wait(dev)
            self._warmed = True
        parts, times = [], []
        for b in self.blocks:
            with _span("kernel.execute", mode="block", block=b.index, fmt=b.fmt):
                _wait(dev)
                t0 = time.perf_counter()
                y = b.kernel(x)
                _wait(dev)
                times.append(time.perf_counter() - t0)
            parts.append(y.cpu().numpy())
        return np.concatenate(parts), times


def compile_partitioned(
    dense: np.ndarray,
    plan: CompositePlan,
    *,
    device: str | torch.device | None = None,
    memo_key: Hashable | None = None,
) -> PartitionedSpmv:
    """Compile every block of ``plan`` through the registry + kernel memo."""
    dense = np.asarray(dense)
    blocks = [
        BlockKernel(
            index=bp.block.index,
            row_start=bp.block.row_start,
            row_end=bp.block.row_end,
            fmt=bp.fmt,
            kernel=compile_spmv_block(
                dense,
                bp.block.row_start,
                bp.block.row_end,
                bp.fmt,
                bp.schedule,
                device=device,
                memo_key=memo_key,
            ),
        )
        for bp in plan.blocks
    ]
    log.info(
        "compiled partitioned kernel: %d block(s), formats=%s",
        len(blocks),
        "+".join(b.fmt for b in blocks),
    )
    return PartitionedSpmv(blocks, plan.partition.n_rows)


class FusedPartitionedSpmv:
    """Heterogeneous composite SpMV in ONE CUDA launch.

    The sequential ``PartitionedSpmv`` pays one kernel launch per block plus
    a concatenation; this wrapper holds the composite lowered to a single
    fused stream (``repro_torch.kernels.fused``): CTA ids map to (block,
    tile) work items through the prefix-sum work descriptor, and every CTA
    adds its runs of rows into the one output vector. Exposes the same
    identity surface as the sequential executor (``formats`` /
    ``n_blocks``) so serving code can treat either interchangeably;
    per-block timing is structurally impossible here (one launch), so
    telemetry-driven paths keep the sequential executor.
    """

    def __init__(self, kernel, plan: CompositePlan):
        self.kernel = kernel  # repro_torch.kernels.fused.FusedSpmv
        self.n_rows = plan.partition.n_rows
        self._formats = tuple(bp.fmt for bp in plan.blocks)
        self._block_ranges = tuple(
            (bp.block.row_start, bp.block.row_end) for bp in plan.blocks
        )

    @property
    def n_blocks(self) -> int:
        return len(self._formats)

    @property
    def formats(self) -> tuple[str, ...]:
        return self._formats

    @property
    def n_tiles(self) -> int:
        return self.kernel.n_tiles

    def descriptor(self) -> dict:
        """Work-descriptor layout (docs/diagnostics): tile size, the CTA id
        -> flat tile map, and each work item's owning block."""
        return {
            "tile": self.kernel.tile,
            "tile_map": self.kernel.tile_map.cpu().tolist(),
            "block_of_tile": list(self.kernel.block_of_tile),
            "block_ranges": list(self._block_ranges),
        }

    def __call__(self, x) -> torch.Tensor:
        with _span(
            "kernel.execute",
            mode="fused",
            n_blocks=self.n_blocks,
            formats="+".join(self.formats),
        ):
            return self.kernel(x)


def compile_fused_partitioned(
    dense: np.ndarray,
    plan: CompositePlan,
    *,
    device: str | torch.device | None = None,
    memo_key: Hashable | None = None,
) -> FusedPartitionedSpmv:
    """Lower ``plan`` to its single-launch executor (one memo entry)."""
    from repro_torch.kernels.ops import compile_spmv_fused

    kernel = compile_spmv_fused(
        np.asarray(dense), plan, device=device, memo_key=memo_key
    )
    fused = FusedPartitionedSpmv(kernel, plan)
    log.info(
        "compiled fused partitioned kernel: %d block(s) -> %d work item(s) "
        "of %d elems, formats=%s",
        fused.n_blocks,
        fused.n_tiles,
        kernel.tile,
        "+".join(fused.formats),
    )
    return fused


class ShardedPartitionedSpmv:
    """Multi-device composite SpMV (one row block per mesh device).

    ``sharded_call`` returns the per-block ``(1, padded_rows)`` outputs, each
    still on the device that computed it (callers composing further work on
    the devices should stay in this form); ``__call__`` gathers the valid
    rows to the host and concatenates them into an ``(n_rows,)`` array.
    """

    def __init__(
        self,
        dense: np.ndarray,
        partition: RowPartition,
        *,
        schedule: KernelSchedule = DEFAULT_SCHEDULE,
        mesh=None,
        device: str | torch.device | None = None,
    ):
        dense = np.asarray(dense)
        self.partition = partition
        self.schedule = schedule
        self.mesh = mesh if mesh is not None else spmv_mesh(partition.n_blocks, device)
        axis_size = self.mesh.shape["data"]
        if partition.n_blocks != axis_size:
            raise ValueError(
                f"partition has {partition.n_blocks} blocks but the mesh "
                f"data axis has {axis_size} devices; partition with "
                f"n_blocks == mesh extent (spmv_mesh(n_blocks))"
            )

        # homogeneous ELL carrier: per-block planes padded to one geometry
        spec = get_format(CARRIER_FORMAT)
        mats = [
            spec.prepare(dense[b.row_start : b.row_end], schedule, device="cpu")
            for b in partition.blocks
        ]
        R = max(int(m.data.shape[0]) for m in mats)
        W = max(int(m.data.shape[1]) for m in mats)
        R, W = ceil_to(R, schedule.rows_per_block), ceil_to(W, schedule.nnz_tile)
        data = np.stack([pad_axis(pad_axis(m.data.numpy(), 0, R), 1, W) for m in mats])
        cols = np.stack([pad_axis(pad_axis(m.cols.numpy(), 0, R), 1, W) for m in mats])

        # dist.sharding rules: blocks axis -> data; X replicated; Y local
        plane_spec = sharding_spec(self.mesh, data.shape, ("blocks", None, None), SPMV_RULES)
        x_spec = sharding_spec(self.mesh, (partition.n_cols,), (None,), SPMV_RULES)
        if tuple(plane_spec) != ("data",) or tuple(x_spec):
            raise ValueError(f"SPMV_RULES gave planes {plane_spec}, x {x_spec} on {self.mesh}")
        # block b's planes on mesh device b
        self.devices = list(self.mesh.devices)
        self.data = [torch.from_numpy(data[b]).to(d) for b, d in enumerate(self.devices)]
        self.cols = [torch.from_numpy(cols[b]).to(d) for b, d in enumerate(self.devices)]
        self.padded_rows = R

    @property
    def n_blocks(self) -> int:
        return self.partition.n_blocks

    def sharded_call(self, x) -> list[torch.Tensor]:
        """Launch B2 on every device of the mesh, each on its current
        stream; block b's ``(1, R)`` output stays on device b."""
        x = torch.as_tensor(x, dtype=torch.float32)
        copies = {d: x.to(d).contiguous() for d in dict.fromkeys(self.devices)}
        with _span("kernel.execute", mode="sharded", n_blocks=self.n_blocks):
            return [
                ell_spmv(d, c, copies[dev], self.schedule)[None, :]
                for d, c, dev in zip(self.data, self.cols, self.devices)
            ]

    def __call__(self, x) -> np.ndarray:
        y = self.sharded_call(x)  # gathers shards to host
        return np.concatenate(
            [y[b.index][0, : b.n_rows].cpu().numpy() for b in self.partition.blocks]
        )


def shard_partitioned(
    dense: np.ndarray,
    plan_or_partition: CompositePlan | RowPartition,
    *,
    schedule: KernelSchedule | None = None,
    mesh=None,
    device: str | torch.device | None = None,
) -> ShardedPartitionedSpmv:
    """Build the multi-device executor from a plan or a bare partition.

    From a ``CompositePlan`` the (uniform) carrier schedule defaults to the
    first block's predicted schedule — per-block *formats* do not transfer to
    the multi-device path (one carrier on every device), only the
    nnz-balanced row map. When the mesh (default: ``spmv_mesh`` over the
    partition's blocks on ``device``) has a different extent than the
    partition, the rows are re-partitioned to one block per device.
    """
    if isinstance(plan_or_partition, CompositePlan):
        partition = plan_or_partition.partition
        if schedule is None:
            schedule = plan_or_partition.blocks[0].schedule
    else:
        partition = plan_or_partition
    from repro_torch.partition.partitioner import partition_rows

    if mesh is None:
        mesh = spmv_mesh(partition.n_blocks, device)
    extent = mesh.shape["data"]
    if partition.n_blocks != extent:
        log.info(
            "re-partitioning %d block(s) -> %d device(s) for the SPMD path",
            partition.n_blocks,
            extent,
        )
        partition = partition_rows(dense, extent)
    return ShardedPartitionedSpmv(
        dense, partition, schedule=schedule or DEFAULT_SCHEDULE, mesh=mesh
    )
