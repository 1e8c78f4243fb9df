"""Blocked-CSR SpMV (kernel B7): CUDA kernel wrapper + its plain PyTorch version.

``bcsr_spmv`` takes ``data (nb_pad, br, bc)``, ``block_cols`` and
``block_rows (nb_pad,)``, ``block_ptr (nbr + 1,)`` and ``x_panels
(n_col_blocks, bc)`` — x padded and reshaped into ``bc``-panels by the
caller — and returns ``y: (nbr, br)``. On a CUDA tensor it launches
``csrc/spmv_bcsr.cu`` or raises; on a CPU tensor — and only then — it
takes ``bcsr_spmv_plain``, which scatters every stored block (padding
blocks into a spill row) by ``block_rows`` as the reference does. The
kernel takes ``bc == 128`` only (what ``prepare`` produces) and ``br`` in
8, 16, ..., 256.

The kernel replaces ``src/repro/sparse/bcsr.py: bcsr_spmv_pallas``. Its
bound on the card is bytes: a block moves ``br * 512`` bytes for
``2 * br * 128`` flops. Its design is B4's (``csrc/block_spmv.cuh``) with a
ragged range per block row: ``block_ptr[i] .. block_ptr[i + 1]`` is cut into
``block_segments`` segments (S from ``nbr`` and the mean blocks per block
row of the padded count, host-side shapes only); one CTA per segment, a
cluster of them per block row, the segment streamed with TMA bulk copies
into a shared-memory ring, rows kept in registers, x panels read once per
block, and the partials added in rank order through distributed shared
memory — no atomics, the same bits on every run. Padding blocks are never
read. A block row far longer than the mean still sets the pace.
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


def bcsr_spmv_plain(
    data: torch.Tensor,
    block_cols: torch.Tensor,
    block_rows: torch.Tensor,
    block_ptr: torch.Tensor,
    x_panels: torch.Tensor,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """Gather panels, per-block ``einsum``, ``index_add_`` over
    ``block_rows`` into ``(nbr + 1, br)`` (the last row takes the padding
    blocks). bf16: operands and products rounded to bf16, the sum taken in
    float32 and rounded once."""
    nbr, br = block_ptr.shape[0] - 1, data.shape[1]
    xseg = x_panels[block_cols.long()]  # (nb_pad, bc)
    if schedule.accum_dtype == "bfloat16":
        v = bf16_round(bf16_round(data) * bf16_round(xseg)[:, None, :]).sum(dim=2)
    else:
        v = torch.einsum("krc,kc->kr", data, xseg)
    y = torch.zeros((nbr + 1, br), dtype=torch.float32, device=x_panels.device)
    y.index_add_(0, block_rows.long(), v)
    y = y[:nbr]
    return bf16_round(y) if schedule.accum_dtype == "bfloat16" else y


def bcsr_spmv(
    data: torch.Tensor,
    block_cols: torch.Tensor,
    block_rows: torch.Tensor,
    block_ptr: torch.Tensor,
    x_panels: torch.Tensor,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """SpMV over flat BCSR storage; returns ``y: (nbr, br)``."""
    dev = x_panels.device
    check_operand(x_panels, "x_panels", torch.float32, 2, dev)
    check_operand(data, "data", torch.float32, 3, dev)
    check_operand(block_cols, "block_cols", torch.int32, 1, dev)
    check_operand(block_rows, "block_rows", torch.int32, 1, dev)
    check_operand(block_ptr, "block_ptr", torch.int32, 1, dev)
    nb_pad, br, bc = data.shape
    if (block_cols.shape[0] != nb_pad or block_rows.shape[0] != nb_pad
            or x_panels.shape[1] != bc or block_ptr.shape[0] < 1):
        raise ValueError("BCSR arrays disagree in shape")
    if dev.type == "cpu":
        return bcsr_spmv_plain(data, block_cols, block_rows, block_ptr, x_panels, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"bcsr_spmv has no kernel for device {dev}")
    if bc != 128:
        raise ValueError(f"the BCSR kernel takes bc == 128, got {bc}")
    if data.data_ptr() % 16 or x_panels.data_ptr() % 16:
        raise ValueError("BCSR data and x_panels must be 16-byte aligned")
    from repro_torch.kernels.build import bind, check_launch

    nbr = block_ptr.shape[0] - 1
    segments = block_segments(nbr, -(-nb_pad // max(nbr, 1)), sm_count(dev))
    y = torch.empty((nbr, br), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_bcsr", "spmv_bcsr_launch",
              [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), block_cols.data_ptr(), block_ptr.data_ptr(),
            x_panels.data_ptr(), y.data_ptr(), nbr, br, bc,
            int(schedule.accum_dtype == "bfloat16"), segments,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "bcsr_spmv")
    bcsr_spmv.launches += 1
    return y


bcsr_spmv.launches = 0  # kernel launches made by this process
