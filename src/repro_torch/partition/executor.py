"""Composite execution of a partitioned plan on one device.

* ``PartitionedSpmv`` — each block's format-specific CUDA kernel (compiled
  through the ``FormatSpec`` registry and the process-wide kernel memo,
  keyed per row range) runs in sequence and the per-block outputs
  concatenate back into ``y`` on the device. Formats are fully
  heterogeneous — this is the paper's run-time mode, per block.

* ``FusedPartitionedSpmv`` — the same composite lowered to one flat stream
  and run as ONE launch of the fused kernel (``repro_torch.kernels.fused``).

The multi-device executor (one row block per card) belongs to a later slice
of the port; this module has no ``ShardedPartitionedSpmv``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Hashable

import numpy as np
import torch

from repro_torch.kernels.ops import PreparedSpmv, compile_spmv_block
from repro_torch.obs.trace import span as _span
from repro_torch.partition.plan import CompositePlan
from repro_torch.utils.logging import get_logger

log = get_logger("partition.executor")


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
