"""Blocked-ELL SpMV: CUDA kernel wrapper + its plain PyTorch version.

``bell_spmv`` takes ``data (nbr, mb, br, bc)``, ``block_cols (nbr, mb)`` and
``x_panels (n_col_blocks, bc)`` — x padded and reshaped into ``bc``-panels by
the caller — and returns ``y: (nbr, br)``. On a CUDA tensor it launches
``csrc/spmv_bell.cu`` (one CTA per block row, a warp per row of the block
row, one ``float4`` of block and panel per lane, shuffle reduce) or raises;
on a CPU tensor — and only then — it takes ``bell_spmv_plain``. With one
right-hand side this is multiply-and-reduce, below any tensor-core tile. The
kernel takes ``bc == 128`` only (what ``prepare`` produces).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand


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
    from repro_torch.kernels.build import bind, check_launch

    y = torch.empty((nbr, br), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_bell", "spmv_bell_launch", [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), block_cols.data_ptr(), x_panels.data_ptr(),
            y.data_ptr(), nbr, mb, br, bc,
            int(schedule.accum_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "bell_spmv")
    bell_spmv.launches += 1
    return y


bell_spmv.launches = 0  # kernel launches made by this process
