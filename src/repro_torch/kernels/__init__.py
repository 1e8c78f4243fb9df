"""Hand-written CUDA kernels for the paper's compute hot-spot: the SpMV
kernel itself (CSR / ELL / BELL / SELL), schedule-parameterized by the
Auto-SpMV compile-time mode. ``ops.py`` is the public wrapper; each kernel
module holds its launch wrapper beside a plain PyTorch version; ``ref.py``
holds the plain-torch oracles; ``build.py`` compiles ``../csrc`` at first use."""

from repro_torch.kernels.common import (
    DEFAULT_SCHEDULE,
    KernelSchedule,
    ROWS_PER_BLOCK_CHOICES,
    NNZ_TILE_CHOICES,
    UNROLL_CHOICES,
    ACCUM_DTYPE_CHOICES,
    X_RESIDENCY_CHOICES,
    resolve_device,
)
from repro_torch.kernels.ops import (
    InfeasibleConfig,
    PreparedSpmv,
    clear_kernel_memo,
    compile_spmv,
    compile_spmv_block,
    evict_kernel_memo_format,
    kernel_memo_limit,
    kernel_memo_size,
    kernel_memo_stats,
    kernel_memoized,
    matrix_fingerprint,
    prepare,
    set_kernel_memo_limit,
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
    "InfeasibleConfig",
    "PreparedSpmv",
    "clear_kernel_memo",
    "compile_spmv",
    "compile_spmv_block",
    "evict_kernel_memo_format",
    "kernel_memo_limit",
    "kernel_memo_size",
    "kernel_memo_stats",
    "kernel_memoized",
    "matrix_fingerprint",
    "prepare",
    "resolve_device",
    "set_kernel_memo_limit",
    "spmv",
]
