"""What a product needs, whatever format serves it, and the card's peaks.

Bytes are counted once per program call: every stored nonzero's value and
column index once, the ``rows + 1`` row pointers once, each input vector read
once and each output vector written once. A call over several vectors (the
engine's ``matmul`` of a decode step's tokens) needs its matrix once, so a
route that reads it once for all of them can approach the bound and none can
pass it. Operations are two per nonzero per vector."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def spmv_call_work(n_rows: int, n_cols: int, nnz: int, vectors: int = 1,
                   value_bytes: int = 4, index_bytes: int = 4) -> tuple[int, int]:
    """``(bytes, flops)`` one call of ``A @ X`` needs, with ``X`` holding
    ``vectors`` columns, at the configuration's precision."""
    matrix = nnz * (value_bytes + index_bytes) + (n_rows + 1) * index_bytes
    vecs = vectors * (n_cols + n_rows) * value_bytes
    return matrix + vecs, 2 * nnz * vectors
