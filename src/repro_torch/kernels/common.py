"""Shared kernel-schedule definition for the CUDA SpMV kernels.

``KernelSchedule`` is the paper's compile-time parameter vector. The field
names, validation and choice sets are those of the reference package, so
schedules, ``TuningConfig.as_dict()``, cache JSON and plans compare
one-to-one between the two; what each knob steers on a Hopper card is:

=====================  =========================  ============================
paper (CUDA)           ``KernelSchedule`` field   Hopper launch parameter
=====================  =========================  ============================
thread-block size      ``rows_per_block``         rows owned by one CTA (SELL:
                                                  slice height C; BELL: block
                                                  height br, capped at 256)
(ILP per thread)       ``nnz_tile``               storage width quantum of
                                                  ELL/SELL: the width loops run
                                                  whole quanta per trip; CSR
                                                  pads nothing and ignores it
maxrregcount           ``unroll``                 independent accumulators per
                                                  thread
L1/shared split        ``x_residency``            ``"vmem"``: x read through
                                                  the read-only/L1 path;
                                                  ``"stream"``: x fetched as a
                                                  128-float panel per stored
                                                  block (BELL only)
(precision)            ``accum_dtype``            float32, or products and
                                                  running sum rounded to bf16
(SM scheduling)        ``dimension_semantics``    ignored by the CUDA kernels:
                                                  CTAs are always independent
=====================  =========================  ============================

128 (four warps) and 8 stay the alignment quanta of ``nnz_tile`` and
``rows_per_block``; both are harmless on a GPU. Re-deriving the choice sets
for the card belongs to the tuner slice.

All kernels accept a ``KernelSchedule`` and honour its tiling; the schedule
is what the Auto-SpMV compile-time mode predicts per input matrix.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

LANE = 128  # nnz_tile / storage-width quantum (four warps)
SUBLANE = 8  # rows_per_block quantum

# Fast-memory budget a schedule's working set must fit for the footprint
# models to call it feasible: the H100's 50 MB L2 (data sheet). x need not
# fit in a block's shared memory for these kernels — they read it through
# the cache hierarchy — so L2, not shared memory, is the bound.
FAST_MEMORY_BYTES = 50 * 1024 * 1024


class InfeasibleConfig(ValueError):
    """Raised when a (format, schedule) pair cannot be materialized.

    The tuner's search space contains invalid points (e.g. a thread-block
    size can exceed resource limits); the dataset harness records them as
    failures rather than crashing. Format plugins raise this from their
    ``prepare``/``spmv`` entrypoints (see
    ``repro_torch.sparse.registry.FormatSpec``).
    """

# Discrete choice sets — the tuning space the classifiers predict over.
ROWS_PER_BLOCK_CHOICES = (8, 16, 32, 64, 128, 256, 512)
NNZ_TILE_CHOICES = (128, 256, 512, 1024)
UNROLL_CHOICES = (1, 2, 4, 8)
ACCUM_DTYPE_CHOICES = ("float32", "bfloat16")
X_RESIDENCY_CHOICES = ("vmem", "stream")
DIMENSION_SEMANTICS_CHOICES = ("parallel", "arbitrary")


@dataclass(frozen=True)
class KernelSchedule:
    rows_per_block: int = 64
    nnz_tile: int = LANE
    unroll: int = 1
    accum_dtype: str = "float32"
    x_residency: str = "vmem"
    dimension_semantics: str = "arbitrary"  # kept for parity; unused on CUDA

    def __post_init__(self):
        if self.rows_per_block % SUBLANE:
            raise ValueError(f"rows_per_block must be a multiple of {SUBLANE}")
        if self.nnz_tile % LANE:
            raise ValueError(f"nnz_tile must be a multiple of {LANE}")
        if self.nnz_tile % self.unroll:
            raise ValueError("unroll must divide nnz_tile")
        if self.accum_dtype not in ACCUM_DTYPE_CHOICES:
            raise ValueError(f"accum_dtype must be one of {ACCUM_DTYPE_CHOICES}")
        if self.x_residency not in X_RESIDENCY_CHOICES:
            raise ValueError(f"x_residency must be one of {X_RESIDENCY_CHOICES}")

    @property
    def torch_accum_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.accum_dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "KernelSchedule":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_SCHEDULE = KernelSchedule()

# Fused partitioned executor (kernels/fused.py): the most CTAs the tile rule
# cuts the single-launch composite stream into — 4 resident CTAs on each of
# the H100's 132 SMs, one wave. CTAs run in parallel here, so unlike a
# sequential grid the launch wants MANY tiles; the cap only keeps a huge
# stream from turning into thousands of tiny CTAs.
H100_SMS = 132
MAX_FUSED_STEPS = 4 * H100_SMS
# the least work a fused CTA gets (8 elements per thread of a 256-thread CTA):
# below it, CTA start-up and the tail atomics cost more than the work
MIN_FUSED_TILE = 2048


def fused_nnz_tile(total_elems: int, *, max_steps: int = MAX_FUSED_STEPS) -> int:
    """Lane-aligned flat tile for the fused composite nonzero stream.

    Rule for the card: one tile is one CTA's work. The tile is the stream
    cut into ``max_steps`` pieces (4 CTAs per SM over 132 SMs, so every SM
    has CTAs to switch between while gathers of x are in flight), but never
    below ``MIN_FUSED_TILE`` elements, and rounded up to a multiple of
    ``LANE``. A stream shorter than ``max_steps * MIN_FUSED_TILE`` therefore
    gets fewer, fuller CTAs; a longer one gets at most ``max_steps`` (plus
    one partial tile per block, since each block pads to the tile). No
    memory cap: a CTA streams its tile from device memory and holds none of
    it, so its size is bounded by nothing on the SM.
    """
    tile = max(-(-int(total_elems) // max_steps), MIN_FUSED_TILE)
    return ceil_to(tile, LANE)


# Block kernels B4 / B7 (csrc/block_spmv.cuh): a block row's live blocks are
# cut into S segments, one CTA each, launched as a cluster of S CTAs; S is a
# power of two up to the portable cluster size.
BLOCK_SEGMENT_CHOICES = (1, 2, 4, 8)
# CTAs per SM in one wave: a block-kernel CTA takes ~100 KB of shared
# memory, so two fit on an SM
BLOCK_CTAS_PER_SM = 2


def block_segments(nbr: int, blocks_per_row: int, n_sms: int) -> int:
    """Segments S per block row for the block kernels, from shapes only.

    The largest S in ``BLOCK_SEGMENT_CHOICES`` whose ``nbr * S`` CTAs still
    fit one wave of ``BLOCK_CTAS_PER_SM`` CTAs per SM, and no more segments
    than ``blocks_per_row`` (BELL: the padded width ``mb``; BCSR: the mean
    stored blocks per block row, rounded up) can fill; at least 1. The CTAs
    of a second wave start only as those of the first finish, and more,
    shorter segments cost more set-up than they balance (``chip_smoke.py``
    times every S). The wrapper calls it with host-side integers, so a
    launch copies nothing from the device.
    """
    s = BLOCK_SEGMENT_CHOICES[0]
    for nxt in BLOCK_SEGMENT_CHOICES[1:]:
        if nbr * nxt > BLOCK_CTAS_PER_SM * n_sms or nxt > max(int(blocks_per_row), 1):
            break
        s = nxt
    return s


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device: the
    launch plans ask on every call)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Asking for CUDA (explicitly or by default) where none is available
    raises — nothing in this package carries on on the CPU by itself; the
    CPU is used only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested (device=None means 'cuda') but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ceil_to(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def pad_axis(a: np.ndarray, axis: int, to: int, fill=0) -> np.ndarray:
    """Pad ``a`` along ``axis`` up to length ``to`` with ``fill``."""
    cur = a.shape[axis]
    if cur >= to:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, to - cur)
    return np.pad(a, widths, constant_values=fill)


def check_operand(
    t, name: str, dtype: torch.dtype, ndim: int, device: torch.device
) -> None:
    """What every kernel wrapper demands of an operand: a contiguous tensor
    of the stated dtype and rank on the same device as x. Raises otherwise —
    a CUDA kernel reads raw pointers and takes nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dim(s), got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and carry on in float32 (the plain versions' bf16
    rounding point)."""
    return t.to(torch.bfloat16).to(torch.float32)
