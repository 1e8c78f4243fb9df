"""Blocked-ELL SpMV (kernel B4): CUDA kernel wrapper + its plain PyTorch version.

``bell_spmv`` takes ``data (nbr, mb, br, bc)``, ``block_cols (nbr, mb)`` and
``x_panels (n_col_blocks, bc)`` — x padded and reshaped into ``bc``-panels by
the caller — and returns ``y: (nbr, br)``. On a CUDA tensor it launches
``csrc/spmv_bell.cu`` or raises; on a CPU tensor — and only then — it takes
``bell_spmv_plain``. The kernel takes ``bc == 128`` only (what ``prepare``
produces) and ``br`` in 8, 16, ..., 256.

The kernel replaces ``src/repro/kernels/bell.py: bell_spmv_pallas``. Its
bound on the card is bytes: a block moves ``br * 512`` bytes for
``2 * br * 128`` flops. Its design (``csrc/block_spmv.cuh``, shared with
B7): each block row's live blocks are one contiguous range, cut into
``block_segments`` segments; one CTA per segment, a cluster of them per
block row; a producer thread streams the segment with TMA bulk copies into
a shared-memory ring, consumer warps keep their rows in registers and read
each block's x panel once, and the segments' partials are added in rank
order through distributed shared memory — no atomics, the same bits on
every run.

Precondition of the kernel (not of the plain version): each block row's
real block columns are strictly ascending and the padding that follows has
block column 0, as ``bell_from_dense`` writes them. The kernel stops at the
first padding block (``bell_live_blocks``) and never reads the rest. The
plain version sums every stored block, as the reference does; the two
differ only where x panel 0 holds a non-finite value, which the reference
carries into every padded block row and the kernel does not.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    KernelSchedule,
    bf16_round,
    block_segments,
    check_operand,
    sm_count,
)
from repro_torch.obs.trace import NOOP_SPAN, get_tracer

_TRACER = get_tracer()


def bell_spmv_plain(
    data: torch.Tensor,
    block_cols: torch.Tensor,
    x_panels: torch.Tensor,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """Gather panels, multiply, sum over (block, column). bf16: operands and
    products rounded to bf16, the sum taken in float32 and rounded once."""
    xseg = x_panels[block_cols.long()]  # (nbr, mb, bc)
    if schedule.accum_dtype == "bfloat16":
        prods = bf16_round(bf16_round(data) * bf16_round(xseg)[:, :, None, :])
        return bf16_round(prods.sum(dim=(1, 3))).to(x_panels.dtype)
    return (data * xseg[:, :, None, :]).sum(dim=(1, 3))


def bell_live_blocks(block_cols: torch.Tensor) -> torch.Tensor:
    """Blocks of each block row the kernel reads: ``(nbr,)`` int64.

    The kernel's rule on ``block_cols (nbr, mb)``: the first ``j > 0`` whose
    column is not greater than column ``j - 1`` starts the padding, else the
    whole row is live. A block row without a real block counts 1 (its one
    all-zero block)."""
    nbr, mb = block_cols.shape
    if mb == 1:
        return torch.ones(nbr, dtype=torch.int64, device=block_cols.device)
    stops = block_cols[:, 1:] <= block_cols[:, :-1]  # (nbr, mb - 1)
    j = torch.arange(1, mb, device=block_cols.device).expand(nbr, mb - 1)
    return torch.where(stops, j, mb).amin(dim=1)


def block_launch_plan(source: str, br: int, segments: int, accum_bf16: bool) -> dict:
    """What one launch of the block kernel in ``csrc/<source>.cu`` takes on
    the current device: stages and chunk bytes of the shared-memory ring,
    dynamic shared memory per CTA, clusters of ``segments`` CTAs the device
    holds at once, threads per CTA. Raises if not one cluster fits."""
    from repro_torch.kernels.build import bind, check_launch

    out = (ctypes.c_int * 5)()
    ci = ctypes.c_int
    fn = bind(source, f"{source}_plan", [ci, ci, ci, ctypes.POINTER(ctypes.c_int)])
    check_launch(fn(br, segments, int(accum_bf16), out), f"{source}_plan")
    keys = ("stages", "chunk_bytes", "smem_bytes", "active_clusters", "threads")
    return {"segments": segments, **dict(zip(keys, out))}


def bell_spmv(
    data: torch.Tensor,
    block_cols: torch.Tensor,
    x_panels: torch.Tensor,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """SpMV over BELL storage; returns ``y: (nbr, br)``."""
    dev = x_panels.device
    check_operand(x_panels, "x_panels", torch.float32, 2, dev)
    check_operand(data, "data", torch.float32, 4, dev)
    check_operand(block_cols, "block_cols", torch.int32, 2, dev)
    nbr, mb, br, bc = data.shape
    if tuple(block_cols.shape) != (nbr, mb) or x_panels.shape[1] != bc:
        raise ValueError("BELL arrays disagree in shape")
    if dev.type == "cpu":
        return bell_spmv_plain(data, block_cols, x_panels, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"bell_spmv has no kernel for device {dev}")
    if bc != 128:
        raise ValueError(f"the BELL kernel takes bc == 128, got {bc}")
    if data.data_ptr() % 16 or x_panels.data_ptr() % 16:
        raise ValueError("BELL data and x_panels must be 16-byte aligned")
    segments = block_segments(nbr, mb, sm_count(dev))
    with _TRACER.span("kernel.launch", kernel="bell_spmv") if _TRACER.enabled else NOOP_SPAN:
        y = _bell_launch(data, block_cols, x_panels, segments, schedule)
    bell_spmv.launches += 1
    return y


def _bell_launch(data, block_cols, x_panels, segments: int,
                 schedule: KernelSchedule) -> torch.Tensor:
    """Launch B4 over ``segments`` on checked CUDA operands; ``y: (nbr, br)``."""
    from repro_torch.kernels.build import bind, check_launch

    dev = x_panels.device
    nbr, mb, br, bc = data.shape
    y = torch.empty((nbr, br), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_bell", "spmv_bell_launch",
              [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), block_cols.data_ptr(), x_panels.data_ptr(),
            y.data_ptr(), nbr, mb, br, bc,
            int(schedule.accum_dtype == "bfloat16"), segments,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "bell_spmv")
    return y


bell_spmv.launches = 0  # kernel launches made by this process
