"""Hand-written CUDA kernels for the paper's compute hot-spot: the SpMV
kernel itself (CSR / ELL / BELL / SELL, the BCSR plugin's ``bcsr.py``),
schedule-parameterized by the Auto-SpMV compile-time mode, the fused
single-launch partitioned kernel (``fused.py``), the sparse-input-vector
SpMSpV kernel (``spmspv.py``) and the ELL SpMM kernel (``ell.py``,
``ops.spmm``). ``ops.py`` is the public
wrapper; each kernel module holds its launch wrapper beside a plain PyTorch
version; ``ref.py`` holds the plain-torch oracles; ``build.py`` compiles
``../csrc`` at first use."""

from repro_torch.kernels.common import (
    DEFAULT_SCHEDULE,
    KernelSchedule,
    ROWS_PER_BLOCK_CHOICES,
    NNZ_TILE_CHOICES,
    UNROLL_CHOICES,
    ACCUM_DTYPE_CHOICES,
    X_RESIDENCY_CHOICES,
    MAX_FUSED_STEPS,
    fused_nnz_tile,
    resolve_device,
)
from repro_torch.kernels.ops import (
    InfeasibleConfig,
    PreparedSpmspv,
    PreparedSpmv,
    clear_kernel_memo,
    compile_spmspv,
    compile_spmv,
    compile_spmv_block,
    compile_spmv_fused,
    evict_kernel_memo_format,
    fused_plan_signature,
    kernel_memo_limit,
    kernel_memo_size,
    kernel_memo_stats,
    kernel_memoized,
    matrix_fingerprint,
    prepare,
    set_kernel_memo_limit,
    spmm,
    spmspv,
    spmv,
)

__all__ = [
    "DEFAULT_SCHEDULE",
    "KernelSchedule",
    "ROWS_PER_BLOCK_CHOICES",
    "NNZ_TILE_CHOICES",
    "UNROLL_CHOICES",
    "ACCUM_DTYPE_CHOICES",
    "X_RESIDENCY_CHOICES",
    "MAX_FUSED_STEPS",
    "fused_nnz_tile",
    "InfeasibleConfig",
    "PreparedSpmspv",
    "PreparedSpmv",
    "clear_kernel_memo",
    "compile_spmspv",
    "compile_spmv",
    "compile_spmv_block",
    "compile_spmv_fused",
    "evict_kernel_memo_format",
    "fused_plan_signature",
    "kernel_memo_limit",
    "kernel_memo_size",
    "kernel_memo_stats",
    "kernel_memoized",
    "matrix_fingerprint",
    "prepare",
    "resolve_device",
    "set_kernel_memo_limit",
    "spmm",
    "spmspv",
    "spmv",
]
