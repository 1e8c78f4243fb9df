"""The host-side rules of the block kernels B4 (BELL) and B7 (BCSR), on the
CPU: where B4 stops reading (its padding rule, ``bell_live_blocks``), how
a block row is cut into segments (``block_segments`` and the kernels'
``segment_range``), and that summing segment by segment and combining the
partials in rank order gives the product. Containers come from both packages' converters;
no test launches a kernel."""

import numpy as np
import pytest
import torch

from repro.sparse.formats import bell_from_dense as ref_bell_from_dense
from repro.sparse.generate import random_matrix
from repro_torch.kernels.bell import bell_live_blocks, bell_spmv_plain
from repro_torch.kernels.common import (
    BLOCK_SEGMENT_CHOICES,
    ROWS_PER_BLOCK_CHOICES,
    KernelSchedule,
    bf16_round,
    block_segments,
)
from repro_torch.sparse.formats import bell_from_dense

from torch_port_helpers import assert_scaled_close, tol_for, with_bcsr  # noqa: F401

LANE = 128


def segment_bounds(count: int, segments: int) -> list[tuple[int, int]]:
    """Blocks [beg, end) of a block row of ``count`` live blocks that each of
    ``segments`` CTAs owns: the kernels' ``segment_range`` in
    ``csrc/block_spmv.cuh`` (count * s / S .. count * (s + 1) / S)."""
    return [(count * s // segments, count * (s + 1) // segments) for s in range(segments)]


def _pattern(name: str, br: int, seed: int = 0) -> np.ndarray:
    """A matrix of 6 block rows x 5 block columns of (br x 128) blocks."""
    rng = np.random.default_rng(seed)
    d = np.zeros((6 * br, 5 * LANE), np.float32)

    def put(i, j):  # one nonzero somewhere in block (i, j)
        d[i * br + rng.integers(br), j * LANE + rng.integers(LANE)] = rng.normal() + 2.0

    if name == "empty_rows":  # block rows 0, 2 and 5 hold nothing
        for i, j in ((1, 0), (1, 3), (3, 2), (3, 4), (4, 1)):
            put(i, j)
    elif name == "column_zero":  # block column 0 occupied, alone and with others
        for i, j in ((0, 0), (1, 0), (1, 1), (2, 0), (2, 4), (3, 0), (4, 0), (4, 2), (4, 3)):
            put(i, j)
    elif name == "single_block_rows":  # one block per row, one of them in column 0
        for i, j in ((0, 4), (1, 0), (2, 2), (3, 1), (4, 3), (5, 0)):
            put(i, j)
    else:
        raise ValueError(name)
    return d


def _occupied(dense: np.ndarray, br: int) -> np.ndarray:
    """Occupied blocks per block row, from the dense matrix alone."""
    n, m = dense.shape
    pr, pc = -(-n // br) * br, -(-m // LANE) * LANE
    padded = np.zeros((pr, pc), dense.dtype)
    padded[:n, :m] = dense
    blocks = padded.reshape(pr // br, br, pc // LANE, LANE)
    return (blocks != 0).any(axis=(1, 3)).sum(axis=1)


def _bell_cols(pkg: str, dense: np.ndarray, br: int):
    if pkg == "reference":
        mat = ref_bell_from_dense(dense, br=br, bc=LANE)
        return (torch.from_numpy(np.array(mat.block_cols)),
                torch.from_numpy(np.array(mat.data)))
    mat = bell_from_dense(dense, br=br, bc=LANE, device="cpu")
    return mat.block_cols, mat.data


@pytest.mark.parametrize("pattern", ["empty_rows", "column_zero", "single_block_rows"])
@pytest.mark.parametrize("rpb", ROWS_PER_BLOCK_CHOICES)
@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_live_blocks_are_the_occupied_blocks(pkg, rpb, pattern):
    """B4's padding rule on both packages' containers: it counts exactly the
    occupied blocks of each block row (one for an empty block row, whose
    single stored block is all zero), and every block past it is zero."""
    br = min(rpb, 256)  # what prepare makes of rows_per_block
    dense = _pattern(pattern, br, seed=rpb)
    cols, data = _bell_cols(pkg, dense, br)
    live = bell_live_blocks(cols)
    occupied = _occupied(dense, br)
    assert live.dtype == torch.int64 and live.shape == (cols.shape[0],)
    np.testing.assert_array_equal(live.numpy(), np.maximum(occupied, 1))
    for i, n in enumerate(live.tolist()):
        assert not data[i, n:].any()  # never read, all zero
        assert (np.diff(cols[i, :n].numpy()) > 0).all()  # the kernel's precondition


@pytest.mark.parametrize("pattern", ["powerlaw", "block", "denserows"])
@pytest.mark.parametrize("br", [8, 64, 256])
def test_live_blocks_on_generated_matrices(br, pattern):
    dense = random_matrix(3 * br + 5, 5.0, pattern, seed=br).astype(np.float32)
    for pkg in ("reference", "port"):
        cols, _ = _bell_cols(pkg, dense, br)
        np.testing.assert_array_equal(bell_live_blocks(cols).numpy(),
                                      np.maximum(_occupied(dense, br), 1))


def _live_only_plain(data, cols, panels, schedule):
    """The plain version over the live blocks only: what B4 computes."""
    live = bell_live_blocks(cols)
    mask = torch.arange(cols.shape[1])[None, :] < live[:, None]
    # padding blocks point at an extra all-zero panel, so nothing of x reaches them
    zero = torch.zeros((1, panels.shape[1]), dtype=panels.dtype)
    live_cols = torch.where(mask, cols, panels.shape[0]).to(cols.dtype)
    return bell_spmv_plain(data, live_cols, torch.cat([panels, zero]), schedule), mask


def test_skipping_padding_changes_nothing_for_finite_x():
    dense = _pattern("empty_rows", 16)
    mat = bell_from_dense(dense, br=16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(5, LANE)).astype(np.float32))
    for acc in ("float32", "bfloat16"):
        s = KernelSchedule(accum_dtype=acc)
        y_live, _ = _live_only_plain(mat.data, mat.block_cols, x, s)
        assert torch.equal(y_live, bell_spmv_plain(mat.data, mat.block_cols, x, s))


def test_non_finite_panel_zero_is_the_one_observable_difference():
    """With inf in x panel 0, summing every stored block (the reference and
    the plain version) turns each padded block row into NaN (0 * inf); B4
    never reads the padding, so a padded block row whose live blocks miss
    block column 0 stays finite. (An empty block row reads its one all-zero
    block, at column 0, and is NaN in both.)"""
    dense = _pattern("empty_rows", 8)
    mat = bell_from_dense(dense, br=8, device="cpu")
    x = torch.ones((5, LANE))
    x[0, 7] = float("inf")
    s = KernelSchedule()
    y_all = bell_spmv_plain(mat.data, mat.block_cols, x, s)
    y_live, mask = _live_only_plain(mat.data, mat.block_cols, x, s)
    touches_0 = ((mat.block_cols == 0) & mask).any(dim=1)
    differs = (~mask).any(dim=1) & ~touches_0  # padded, live blocks miss column 0
    assert differs.any()
    assert torch.isnan(y_all[differs]).all() and torch.isfinite(y_live[differs]).all()
    same = ~differs
    assert torch.equal(y_all[same].isnan(), y_live[same].isnan())


# ----------------------------------------------------------- block_segments
@pytest.mark.parametrize("S", BLOCK_SEGMENT_CHOICES)
@pytest.mark.parametrize("count", [0, 1, 2, 3, 7, 8, 35, 1000])
def test_segments_cover_every_live_block_once(S, count):
    bounds = segment_bounds(count, S)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == count
    covered = [j for beg, end in bounds for j in range(beg, end)]
    assert covered == list(range(count))  # each once, in rank order
    sizes = [end - beg for beg, end in bounds]
    assert max(sizes) - min(sizes) <= 1  # near-equal


@pytest.mark.parametrize("nbr,blocks_per_row,n_sms", [
    (125, 35, 132), (125, 30, 132), (1000, 30, 132), (14, 2, 132), (14, 1, 132),
    (47, 24, 132), (1, 1000, 132), (264, 9, 132), (0, 0, 132), (6, 3, 16),
])
def test_block_segments_from_integers_only(nbr, blocks_per_row, n_sms):
    S = block_segments(nbr, blocks_per_row, n_sms)
    assert S in BLOCK_SEGMENT_CHOICES
    assert S == block_segments(np.int64(nbr), np.int32(blocks_per_row), int(n_sms))
    assert S <= max(blocks_per_row, 1)  # no segment is empty by construction
    # S is the largest power of two that keeps nbr * S CTAs within one wave
    # of two CTAs per SM (and within blocks_per_row), at least 1
    if S > 1:
        assert nbr * S <= 2 * n_sms
    nxt = 2 * S
    if nxt in BLOCK_SEGMENT_CHOICES and nxt <= blocks_per_row:
        assert nbr * nxt > 2 * n_sms
    # every live block of every block row is covered once
    rng = np.random.default_rng(nbr + blocks_per_row)
    for count in rng.integers(0, max(blocks_per_row, 1) + 1, size=min(nbr, 50)):
        spans = segment_bounds(int(count), S)
        assert sum(end - beg for beg, end in spans) == count


# ------------------------------------- the segmented sum, as the kernel takes it
def _segmented(blocks_of_row, panels, S, schedule):
    """y of one block row: each segment's partial over its blocks, then the
    S partials added in rank order (bf16: every partial and sum rounded)."""
    data, cols = blocks_of_row
    bf16 = schedule.accum_dtype == "bfloat16"
    total = None
    for beg, end in segment_bounds(data.shape[0], S):
        d, xs = data[beg:end], panels[cols[beg:end].long()]
        if bf16:
            part = bf16_round(bf16_round(bf16_round(d) * bf16_round(xs)[:, None, :]).sum(dim=(0, 2)))
        else:
            part = torch.einsum("brc,bc->r", d, xs)
        total = part if total is None else (bf16_round(total + part) if bf16 else total + part)
    return total


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", BLOCK_SEGMENT_CHOICES)
@pytest.mark.parametrize("br", [8, 64])
def test_segment_partials_in_rank_order_give_the_product(with_bcsr, br, S, acc):
    from repro_torch.sparse.bcsr import bcsr_from_dense

    dense = random_matrix(6 * br, 9.0, "powerlaw", seed=S).astype(np.float32)
    n = dense.shape[0]
    x = np.random.default_rng(br).normal(size=n).astype(np.float32)
    panels = torch.zeros(-(-n // LANE) * LANE)
    panels[:n] = torch.from_numpy(x)
    panels = panels.reshape(-1, LANE)
    s = KernelSchedule(accum_dtype=acc)
    truth = dense.astype(np.float64) @ x
    bell = bell_from_dense(dense, br=br, device="cpu")
    live = bell_live_blocks(bell.block_cols)
    y_bell = torch.stack([
        _segmented((bell.data[i, :k], bell.block_cols[i, :k]), panels, S, s)
        for i, k in enumerate(live.tolist())]).reshape(-1)[:n]
    bcsr = bcsr_from_dense(dense, br=br, pad_blocks_to=4, device="cpu")
    ptr = bcsr.block_ptr.tolist()
    y_bcsr = torch.stack([
        _segmented((bcsr.data[a:b], bcsr.block_cols[a:b]), panels, S, s)
        for a, b in zip(ptr[:-1], ptr[1:])]).reshape(-1)[:n]
    for y in (y_bell, y_bcsr):
        assert_scaled_close(y.numpy(), truth, tol_for(acc))
    # the plain version (every stored block, one float32 sum) agrees
    y_plain = bell_spmv_plain(bell.data, bell.block_cols, panels, s).reshape(-1)[:n]
    assert_scaled_close(y_bell.numpy(), y_plain.numpy(), tol_for(acc))
