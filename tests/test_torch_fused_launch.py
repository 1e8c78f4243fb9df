"""The host-side rules of kernel B5 (the fused composite), on the CPU: its
launch plan (``fused_launch_plan``: pieces of the stream, each CTA's row
window, the rows shared by several pieces and their scratch slots, the zero
runs) on streams lowered from every block format, and a numpy emulation of
the kernel's summation order read from the packed plan as the kernel reads
it (segmented scans of a warp's sub-steps, run sums added into the warp's
window slice in lane order, a piece's warp slices added in warp order,
shared rows' partials in piece order). The emulation is held against the plain version and against
the reference's Pallas kernel (interpret mode) on the same streams, and
against itself run twice, bit for bit. No test launches a kernel.

Tolerances as in ``tests/test_torch_fused.py``: scaled by max |reference|,
1e-4 for float32 and 3e-2 for bfloat16 accumulation."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.fused import fused_spmv_pallas
from repro.kernels.fused import lower_fused as ref_lower
from repro.sparse.generate import random_matrix
from repro_torch.kernels.common import fused_nnz_tile
from repro_torch.kernels.fused import (
    FUSED_ALIGN,
    FUSED_CTAS_PER_SM,
    FUSED_DIRECT,
    FUSED_GROUP_INTS,
    FUSED_MIN_PIECE,
    FUSED_PAD_ROW,
    FUSED_PIECES_PER_SM,
    FUSED_PIECE_INTS,
    FUSED_SKIP,
    FUSED_STEPS,
    FUSED_THREADS,
    FUSED_WINDOW,
    FUSED_ZERO_RUN,
    fused_launch_plan,
    fused_piece_len,
    fused_plan_summary,
    fused_spmv,
    fused_spmv_plain,
    lower_fused,
)

from torch_port_helpers import (
    assert_scaled_close,
    hetero_matrix,
    plan_pair,
    tol_for,
    with_bcsr,  # noqa: F401  (fixture)
)

H100_SMS = 132
WARPS = FUSED_THREADS // 32
KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/spmv_fused.cu"


# ------------------------------------------------------------- streams


def _sparse_rows(n: int = 1200, seed: int = 5) -> np.ndarray:
    """A power-law CSR block's shape at its sparsest: two rows in three
    empty, the rest with 1-4 nonzeros, so a few hundred elements span more
    rows than a window holds."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, 96), np.float32)
    for r in range(n):
        if r % 3:
            continue
        cc = rng.choice(96, size=rng.integers(1, 5), replace=False)
        d[r, cc] = rng.normal(size=cc.size) + 2.0
    return d


def _sell_tail(n: int = 256, seed: int = 9) -> np.ndarray:
    """SELL slices whose rows differ in length: past the short rows'
    nonzeros, one row recurs within 32 consecutive stream elements."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, 128), np.float32)
    for r in range(n):
        k = 40 if r % 16 == 3 else int(rng.integers(1, 4))
        d[r, rng.choice(128, size=k, replace=False)] = rng.normal(size=k) + 2.0
    return d


# name: (dense, formats, blocks, schedule keywords)
CASES = {
    "sell_c32": (lambda: random_matrix(256, 6.0, "fem", seed=3), ["sell"], 2,
                 dict(rows_per_block=32)),
    "sell_tail": (_sell_tail, ["sell"], 2, dict(rows_per_block=32)),
    "sell_c128": (lambda: random_matrix(256, 6.0, "powerlaw", seed=4), ["sell"], 1,
                  dict(rows_per_block=128, nnz_tile=256)),
    "bell_block_rows": (lambda: hetero_matrix(256), ["bell"], 2, dict(rows_per_block=8)),
    "csr_empty_rows": (_sparse_rows, ["csr"], 2, {}),
    "ell": (lambda: random_matrix(256, 8.0, "banded", seed=6), ["ell"], 2, {}),
    "hetero_four": (lambda: hetero_matrix(256), ["csr", "ell", "bell", "sell"], 4, {}),
    "zero_tile_block": (lambda: _zero_middle(), ["ell", "csr"], 4, {}),  # rows 32-95 empty
    "all_empty": (lambda: np.zeros((64, 64), np.float32), ["csr"], 2, {}),
    "bcsr_plugin": (lambda: hetero_matrix(256), ["bcsr", "csr", "ell", "sell"], 4, {}),
}


def _zero_middle() -> np.ndarray:
    dense = random_matrix(128, 5.0, "fem", seed=1).astype(np.float32)
    dense[32:96] = 0.0  # the middle blocks hold no nonzero: zero tiles
    return dense


# blocks of 32 rows where the case's rows are cut so (the nnz balance would
# give every block nonzeros)
EDGES = {"zero_tile_block": (0, 32, 64, 96, 128)}


def _with_edges(plan, edges):
    """``plan`` with its blocks moved to the row ranges ``edges`` gives."""
    blocks = tuple(
        dataclasses.replace(bp, block=dataclasses.replace(bp.block, row_start=a, row_end=b))
        for bp, a, b in zip(plan.blocks, edges[:-1], edges[1:]))
    return dataclasses.replace(plan, blocks=blocks)


def _lowered(name, request, accum="float32"):
    make, fmts, k, kw = CASES[name]
    if "bcsr" in fmts:
        request.getfixturevalue("with_bcsr")
    dense = np.asarray(make(), np.float32)
    ref_plan, plan = plan_pair(dense, fmts, k, {**kw, "accum_dtype": accum})
    if name in EDGES:
        ref_plan, plan = (_with_edges(p, EDGES[name]) for p in (ref_plan, plan))
    return dense, ref_plan, lower_fused(dense, plan, device="cpu")


def _host(f):
    return (f.data.numpy(), f.cols.numpy(), f.rows.numpy(), f.tile_map.numpy())


# ------------------------------------------------------------- invariants


def _touching(rows_v, starts, lives, n_rows):
    """Brute force: the set of rows each piece's live elements touch."""
    out = []
    for s, n in zip(starts, lives):
        r = rows_v[s : s + n]
        out.append(set(np.unique(r[r != n_rows]).tolist()))
    return out


def check_plan(plan, rows, tile_map, tile, n_rows):
    """Every invariant the kernel relies on; returns the plan's pieces'
    row sets."""
    P = plan["ctas"]
    pieces = plan["pieces"]
    start, length, live = pieces[:, 0], pieces[:, 1], pieces[:, 2]
    assert P >= 1 and len(pieces) == P
    # every element of every tile_map entry lies in exactly one piece of it
    covered = np.zeros(rows.size, np.int64)
    for s, n in zip(start, length):
        covered[s : s + n] += 1
        assert n == 0 or s // tile == (s + n - 1) // tile  # a piece stays in its tile
    want = np.repeat(np.bincount(tile_map, minlength=rows.size // tile if tile else 0), tile)
    np.testing.assert_array_equal(covered, want[: rows.size])
    # the live part ends at the piece's last real element; the rest is padding
    for s, n, lv in zip(start, length, live):
        assert 0 <= lv <= n
        assert (rows[s + lv : s + n] == n_rows).all()
        assert lv == 0 or rows[s + lv - 1] != n_rows
    # windows: tight, within the cap
    sets = _touching(rows, start, live, n_rows)
    for p, rs in enumerate(sets):
        if rs:
            assert plan["rlo"][p] == min(rs) and plan["width"][p] == max(rs) - min(rs) + 1
        else:
            assert plan["width"][p] == 0
    assert (plan["width"] <= FUSED_WINDOW).all() and plan["max_window"] <= FUSED_WINDOW
    # codes: direct where the row is this piece's alone, a slot where shared
    owners: dict[int, list[int]] = {}
    for p, rs in enumerate(sets):
        for r in rs:
            owners.setdefault(r, []).append(p)
    writes = np.zeros(n_rows + 1, np.int64)
    slots = []
    for p in range(P):
        t0, W = plan["table_off"][p], plan["width"][p]
        codes = plan["codes"][t0 : t0 + W]
        for j, c in enumerate(codes.tolist()):
            r = int(plan["rlo"][p]) + j
            if r not in sets[p]:
                assert c == FUSED_SKIP
            elif len(owners[r]) == 1:
                assert c == FUSED_DIRECT
                writes[r] += 1
            else:
                assert c >= 0
                slots.append(c)
    # shared rows: groups of one piece set, slots base + q * m + j
    groups = plan["groups"]
    assert len(groups) == plan["n_groups"]
    grows = plan["group_rows"]
    for g, (roff, m, npieces, base) in enumerate(groups.tolist()):
        rs = grows[roff : roff + m].tolist()
        assert rs == sorted(rs) and m >= 1 and npieces >= 2
        members = owners[rs[0]]
        assert len(members) == npieces
        for j, r in enumerate(rs):
            assert owners[r] == members  # one set of pieces per group
            writes[r] += 1
            for q, p in enumerate(members):
                t0 = plan["table_off"][p] + r - plan["rlo"][p]
                assert plan["codes"][t0] == base + q * m + j
        for p in members:
            ptr = plan["piece_group_ptr"]
            assert g in plan["piece_groups"][ptr[p] : ptr[p + 1]].tolist()
    assert sum(len(v) >= 2 for v in owners.values()) == plan["shared_rows"]
    # scratch slots: disjoint, filling [0, scratch)
    assert sorted(slots) == list(range(plan["scratch"]))
    # zero runs: every row no piece touches, and the spill slot
    for lo, hi in plan["zero_runs"].tolist():
        assert 0 < hi - lo <= FUSED_ZERO_RUN
        writes[lo:hi] += 1
    np.testing.assert_array_equal(writes, np.ones(n_rows + 1, np.int64))
    assert plan["writes"] == n_rows + 1 + plan["scratch"]
    # the packed layout says the same
    pk, off = plan["packed"], plan["offsets"]
    assert pk.dtype == np.int32
    head = pk[: P * FUSED_PIECE_INTS].reshape(P, FUSED_PIECE_INTS)
    np.testing.assert_array_equal(head[:, 0], start)
    np.testing.assert_array_equal(head[:, 1], live)
    np.testing.assert_array_equal(head[:, 2], plan["rlo"])
    np.testing.assert_array_equal(head[:, 3], plan["width"])
    np.testing.assert_array_equal(pk[off["table"] : off["pgroups"]], plan["codes"])
    np.testing.assert_array_equal(
        pk[off["groups"] : off["grows"]].reshape(-1, FUSED_GROUP_INTS), groups)
    np.testing.assert_array_equal(pk[off["zero"] :].reshape(-1, 2), plan["zero_runs"])
    # window rows: each live element's row as an offset into its window
    wr = plan["window_rows"]
    assert wr.dtype == np.uint8 and wr.size == rows.size
    for s, n, lv, lo in zip(start, length, live, plan["rlo"]):
        r = rows[s : s + n].astype(np.int64)
        want = np.where(r != n_rows, r - lo, FUSED_PAD_ROW)
        want[lv:] = FUSED_PAD_ROW
        np.testing.assert_array_equal(wr[s : s + n], want)
    return sets


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_invariants_on_lowered_streams(name, request):
    dense, _, f = _lowered(name, request)
    _, _, rows, tmap = _host(f)
    plan = fused_launch_plan(rows, tmap, f.tile, f.n_rows, H100_SMS)
    check_plan(plan, rows, tmap, f.tile, f.n_rows)
    # lower_fused keeps the same plan, its packed array as the buffer
    kept = f.launch_plan
    np.testing.assert_array_equal(kept["packed"], plan["packed"])
    np.testing.assert_array_equal(kept["buffers"][0].numpy(), plan["packed"])
    np.testing.assert_array_equal(kept["buffers"][1].numpy(), plan["window_rows"])
    assert fused_plan_summary(kept) == fused_plan_summary(plan)


def test_zero_tile_block_and_all_empty_matrix_write_zeros(request):
    """A block with zero tiles: its rows are zero runs. The all-empty matrix
    (one all-spill tile): one piece with nothing live stores every row."""
    _, _, f = _lowered("zero_tile_block", request)
    assert [sum(1 for b in f.block_of_tile if b == i) for i in range(4)][1:3] == [0, 0]
    zr = f.launch_plan["zero_runs"].tolist()
    assert [32, 96] in zr
    assert zr[-1][1] == f.n_rows + 1  # the spill slot
    _, _, f = _lowered("all_empty", request)
    lp = f.launch_plan
    assert lp["ctas"] == 1 and lp["pieces"][0].tolist() == [0, f.tile, 0]
    assert lp["zero_runs"].tolist() == [[0, 65]] and lp["scratch"] == 0


def test_window_cut_on_a_sparse_csr_block():
    """Empty rows make a few hundred elements span more rows than a window
    holds: the plan cuts there, and every window fits."""
    dense = _sparse_rows(3000)
    _, plan = plan_pair(dense, ["csr"], 1)
    f = lower_fused(dense, plan, device="cpu")
    _, _, rows, tmap = _host(f)
    for piece in (None, 2048, f.tile):
        p = fused_launch_plan(rows, tmap, f.tile, f.n_rows, H100_SMS, piece=piece)
        check_plan(p, rows, tmap, f.tile, f.n_rows)
        assert p["max_window"] <= FUSED_WINDOW
    wide = fused_launch_plan(rows, tmap, f.tile, f.n_rows, H100_SMS, piece=f.tile)
    assert wide["ctas"] > f.n_tiles  # cut by the window, not by the piece length


def test_window_cut_at_every_element_where_rows_lie_far_apart():
    """Rows further apart than the window: each element its own piece."""
    n_rows, tile = 20 * FUSED_WINDOW, 128
    rows = np.full(tile, n_rows, np.int32)
    rows[:20] = np.arange(20) * FUSED_WINDOW
    plan = fused_launch_plan(rows, np.zeros(1, np.int32), tile, n_rows, H100_SMS)
    check_plan(plan, rows, np.zeros(1, np.int64), tile, n_rows)
    assert plan["ctas"] == 20 and plan["shared_rows"] == 0


@pytest.mark.parametrize("order", ["reversed", "duplicated"])
def test_plan_follows_the_work_descriptor(order, request):
    """Pieces take the tiles in ``tile_map`` order; a tile named twice gives
    pieces that share its rows (the plain version adds it twice too)."""
    dense, _, f = _lowered("hetero_four", request)
    _, _, rows, tmap = _host(f)
    tmap = tmap[::-1].copy() if order == "reversed" else np.append(tmap[:-1], tmap[0])
    plan = fused_launch_plan(rows, tmap, f.tile, f.n_rows, H100_SMS)
    check_plan(plan, rows, tmap.astype(np.int64), f.tile, f.n_rows)
    first = plan["pieces"][0, 0] // f.tile
    assert first == tmap[0]


def _stream(counts: np.ndarray, n_rows: int, tile: int | None = None):
    """A row-major (CSR-like) stream with ``counts[r]`` elements in row r,
    padded to ``tile`` (the port's tile rule unless given): (rows, tile_map,
    tile)."""
    rows = np.repeat(np.arange(n_rows, dtype=np.int32), counts)
    tile = tile or fused_nnz_tile(max(rows.size, 1))
    n_tiles = -(-rows.size // tile)
    rows = np.pad(rows, (0, n_tiles * tile - rows.size), constant_values=n_rows)
    return rows, np.arange(n_tiles, dtype=np.int32), tile


def test_grid_fills_the_card_at_amazon0601_size():
    """53 k elements over 14,000 rows (amazon0601's composite): the stored
    tile rule gives 26 tiles, the plan well over one CTA per SM."""
    rng = np.random.default_rng(0)
    n_rows = 14_000
    weight = rng.pareto(1.5, n_rows) + 1.0  # power-law rows, as a web graph's
    counts = rng.multinomial(52_955, weight / weight.sum())
    rows, tmap, tile = _stream(counts, n_rows)
    assert tmap.size == 26
    plan = fused_launch_plan(rows, tmap, tile, n_rows, H100_SMS)
    assert plan["ctas"] > H100_SMS
    assert plan["piece"] == FUSED_MIN_PIECE == fused_piece_len(52_955, H100_SMS)
    check_plan(plan, rows, tmap.astype(np.int64), tile, n_rows)


def test_a_large_stream_is_cut_by_the_sm_count_not_by_its_tiles():
    """A stream with few stored tiles is cut into ``FUSED_PIECES_PER_SM``
    pieces per SM (plus one per tile boundary), which one wave of
    ``FUSED_CTAS_PER_SM`` resident CTAs per SM holds."""
    n_rows = 2_000
    rows, tmap, tile = _stream(np.full(n_rows, 600), n_rows, tile=65_536)
    assert tmap.size < H100_SMS
    plan = fused_launch_plan(rows, tmap, tile, n_rows, H100_SMS)
    target = FUSED_PIECES_PER_SM * H100_SMS
    # each tile in equal pieces, as many as pieces of about `piece` elements
    assert target - tmap.size <= plan["ctas"] <= target + tmap.size
    assert plan["ctas"] <= FUSED_CTAS_PER_SM * H100_SMS
    assert plan["max_window"] <= 10  # rows of 600: a piece of 4,544 spans at most 9
    assert plan["writes"] == n_rows + 1 + plan["scratch"]


def test_plan_refuses_a_stream_it_cannot_launch():
    rows = np.zeros(256, np.int32)
    with pytest.raises(ValueError):  # length is not n_tiles * tile
        fused_launch_plan(rows, np.arange(3, dtype=np.int32), 128, 8, H100_SMS)
    with pytest.raises(ValueError):  # a tile that is not in the stream
        fused_launch_plan(rows, np.array([0, 2], np.int32), 128, 8, H100_SMS)
    with pytest.raises(ValueError):  # a tile that is not whole 16-byte units of window rows
        fused_launch_plan(np.zeros(240, np.int32), np.arange(2, dtype=np.int32), 120, 8, H100_SMS)
    with pytest.raises(ValueError):  # a row id beyond the spill slot
        fused_launch_plan(np.full(128, 9, np.int32), np.zeros(1, np.int32), 128, 8, H100_SMS)


def test_plan_constants_are_the_kernels():
    """The plan's constants are those csrc/spmv_fused.cu declares (the card
    run also reads them from the built library)."""
    src = KERNEL_SOURCE.read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (-?\d+);", src)}
    assert got["kThreads"] == FUSED_THREADS and got["kWindow"] == FUSED_WINDOW
    assert got["kSteps"] == FUSED_STEPS and got["kPieceInts"] == FUSED_PIECE_INTS
    assert got["kGroupInts"] == FUSED_GROUP_INTS and got["kCtasPerSm"] == FUSED_CTAS_PER_SM
    assert got["kAlign"] == FUSED_ALIGN
    assert got["kDirect"] == FUSED_DIRECT and got["kSkip"] == FUSED_SKIP
    pad = re.search(r"constexpr int kPadRow = (0x[0-9A-F]+);", src).group(1)
    assert int(pad, 16) == FUSED_PAD_ROW
    assert "atomicAdd(y" not in src and "cudaMemsetAsync" not in src


# ------------------------------------------------------------- emulation


def _bf16(a) -> np.ndarray:
    """Round float32 to bfloat16, nearest even, and back (``__float2bfloat16``)."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _ops(accum):
    if accum == "bfloat16":
        return (lambda a, b: _bf16(np.float32(a) + np.float32(b)),
                lambda d, x: _bf16(_bf16(d) * _bf16(x)))
    return (lambda a, b: np.float32(a) + np.float32(b),
            lambda d, x: np.asarray(d, np.float32) * np.asarray(x, np.float32))


LANE = np.arange(32)


def _sub_step(win, local, v, valid, add, seen):
    """One warp sub-step as the kernel takes it: a segmented Hillis-Steele
    scan over runs of equal consecutive rows, then each run's sum into the
    warp's slice, in lane order (the kernel adds the stretches between
    decreasing rows in turn; within one their rows are distinct)."""
    key = np.where(valid, local, FUSED_WINDOW)
    head = (LANE == 0) | (key != np.roll(key, 1))
    first = np.maximum.accumulate(np.where(head, LANE, 0))
    for d in (1, 2, 4, 8, 16):
        t = np.roll(v, d)
        v = np.where(LANE - d >= first, add(t, v), v)
    tail = valid & np.append(head[1:], True)
    seen["repeats"] += np.unique(local[tail]).size < int(tail.sum())
    seen["stretches"] = max(seen.get("stretches", 0), int((key[1:] < key[:-1]).sum()) + 1)
    for lane in LANE[tail]:
        win[local[lane]] = add(win[local[lane]], v[lane])


def emulate(data, cols, x, plan, accum, seen=None):
    """The kernel's y, from the plan's packed array and window rows as the
    kernel reads them (it reads no row id). y and the partials start as NaN,
    so a slot nobody writes shows."""
    add, prod = _ops(accum)
    seen = {"repeats": 0} if seen is None else seen
    pk, off, wrows = plan["packed"], plan["offsets"], plan["window_rows"].astype(np.int64)
    n_rows, P = plan["n_rows"], plan["ctas"]
    y = np.full(n_rows + 1, np.nan, np.float32)
    partials = np.full(plan["scratch"], np.nan, np.float32)
    trip = FUSED_THREADS * FUSED_STEPS
    for p in range(P):
        start, live, rlo, width, table, _, _, _ = (
            int(v) for v in pk[p * FUSED_PIECE_INTS : (p + 1) * FUSED_PIECE_INTS])
        win = np.zeros((WARPS, width), np.float32)
        # trips from the piece's start rounded down to a 16-byte unit of rows
        a0 = start - start % FUSED_ALIGN
        for base in range(a0, start + live, trip):
            for w in range(WARPS):
                rs, vs = [], []
                for u in range(FUSED_STEPS):
                    o = base + (w * FUSED_STEPS + u) * 32 + LANE
                    inb = (o >= start) & (o < start + live)
                    k = np.where(inb, o, start)
                    r = np.where(inb, wrows[k], FUSED_PAD_ROW)
                    valid = r != FUSED_PAD_ROW
                    rs.append(r)
                    vs.append(np.where(valid, prod(data[k], x[np.where(valid, cols[k], 0)]),
                                       np.float32(0)).astype(np.float32))
                if all((r == rs[0]).all() for r in rs):  # one row a lane: add in registers
                    seen["one_row"] = seen.get("one_row", 0) + 1
                    v = vs[0]
                    for u in range(1, FUSED_STEPS):
                        v = add(v, vs[u])
                    rs, vs = rs[:1], [v]
                for r, v in zip(rs, vs):
                    valid = r != FUSED_PAD_ROW
                    if valid.any():
                        _sub_step(win[w], np.where(valid, r, 0), v, valid, add, seen)
        codes = pk[off["table"] + table : off["table"] + table + width]
        for j in np.flatnonzero(codes != FUSED_SKIP):
            s = win[0, j]
            for w in range(1, WARPS):
                s = add(s, win[w, j])
            if codes[j] == FUSED_DIRECT:
                y[rlo + j] = s
            else:
                partials[codes[j]] = s
    for lo, hi in pk[off["zero"] :].reshape(-1, 2):
        y[lo:hi] = 0.0
    groups = pk[off["groups"] : off["grows"]].reshape(-1, FUSED_GROUP_INTS)
    for roff, m, npieces, base in groups.tolist():
        s = partials[base : base + m]
        for q in range(1, npieces):
            s = add(s, partials[base + q * m : base + (q + 1) * m])
        y[pk[off["grows"] + roff : off["grows"] + roff + m]] = s
    return y


EMULATED = ["sell_c32", "sell_tail", "bell_block_rows", "csr_empty_rows", "ell",
            "hetero_four", "zero_tile_block", "all_empty", "bcsr_plugin"]


def _x(n, seed=4):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", EMULATED)
def test_emulated_kernel_matches_the_plain_version(name, accum, request):
    dense, _, f = _lowered(name, request, accum)
    data, cols, rows, tmap = _host(f)
    x = _x(dense.shape[1])
    y = emulate(data, cols, x, f.launch_plan, f.accum_dtype)
    assert np.isfinite(y).all() and y[-1] == 0.0  # every slot written; spill 0
    y_plain = fused_spmv_plain(*(torch.from_numpy(a) for a in (data, cols, rows, tmap)),
                               torch.from_numpy(x), f.n_rows, f.tile,
                               accum_dtype=f.accum_dtype).numpy()
    tol = tol_for(f.accum_dtype)
    assert_scaled_close(y[:-1], y_plain[:-1], tol)
    assert_scaled_close(y[:-1], dense.astype(np.float64) @ x, tol)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sell_c32", "bell_block_rows", "csr_empty_rows",
                                  "hetero_four", "zero_tile_block"])
def test_emulated_kernel_matches_the_reference_kernel(name, accum, request):
    """The reference lowers; its stream goes to its Pallas kernel
    (interpret mode) and, with a plan built from it, to the emulation."""
    dense, ref_plan, _ = _lowered(name, request, accum)
    ref = ref_lower(dense, ref_plan)
    x = _x(dense.shape[1], seed=7)
    y_ref = np.asarray(fused_spmv_pallas(
        ref.data, ref.cols, ref.rows, ref.tile_map, x, ref.n_rows, ref.tile,
        unroll=ref.unroll, accum_dtype=ref.accum_dtype, interpret=True))
    data, cols, rows, tmap = (np.asarray(a) for a in (ref.data, ref.cols, ref.rows,
                                                       ref.tile_map))
    plan = fused_launch_plan(rows, tmap, ref.tile, ref.n_rows, H100_SMS)
    check_plan(plan, rows, tmap.astype(np.int64), ref.tile, ref.n_rows)
    y = emulate(data, cols, x, plan, ref.accum_dtype)
    assert_scaled_close(y[:-1], y_ref[:-1], tol_for(ref.accum_dtype))


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sell_tail", "hetero_four", "bcsr_plugin"])
def test_emulated_kernel_gives_the_same_bits_twice(name, accum, request):
    dense, _, f = _lowered(name, request, accum)
    data, cols, rows, _ = _host(f)
    x = _x(dense.shape[1], seed=8)
    a = emulate(data, cols, x, f.launch_plan, f.accum_dtype)
    b = emulate(data, cols, x, f.launch_plan, f.accum_dtype)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_rows_that_recur_within_a_sub_step_are_exercised(request):
    """The SELL tail case reaches the kernel's path of stretches (a row ends
    two runs of one sub-step) and still matches the plain version; at the
    lowering's piece sizes and at pieces cut by the window."""
    dense, _, f = _lowered("sell_tail", request)
    data, cols, rows, tmap = _host(f)
    x = _x(dense.shape[1], seed=2)
    y_plain = fused_spmv_plain(*(torch.from_numpy(a) for a in (data, cols, rows, tmap)),
                               torch.from_numpy(x), f.n_rows, f.tile).numpy()
    for piece in (None, 64):
        plan = fused_launch_plan(rows, tmap, f.tile, f.n_rows, H100_SMS, piece=piece)
        seen = {"repeats": 0}
        y = emulate(data, cols, x, plan, "float32", seen)
        assert seen["repeats"] > 0
        assert_scaled_close(y[:-1], y_plain[:-1], 1e-4)


def test_sell_slices_of_eight_rows(request):
    """A SELL slice of 8 rows that all stay live: 32 stream elements are four
    columns of the slice's rows, four stretches whose rows repeat, and each
    lane holds one row in every sub-step of a trip (the register path); the
    emulated order still matches the plain version, bit for bit twice."""
    dense = np.zeros((64, 256), np.float32)
    rng = np.random.default_rng(3)
    for r in range(64):
        k = 160 if r % 8 else 150  # the slice's first row runs out first
        dense[r, rng.choice(256, size=k, replace=False)] = rng.normal(size=k) + 2.0
    _, plan = plan_pair(dense, ["sell"], 1, dict(rows_per_block=8))
    f = lower_fused(dense, plan, device="cpu")
    data, cols, rows, tmap = _host(f)
    x = _x(256, seed=5)
    seen = {"repeats": 0}
    y = emulate(data, cols, x, f.launch_plan, "float32", seen)
    assert seen["repeats"] > 0 and seen["stretches"] >= 4 and seen["one_row"] > 0
    y_plain = fused_spmv_plain(*(torch.from_numpy(a) for a in (data, cols, rows, tmap)),
                               torch.from_numpy(x), f.n_rows, f.tile).numpy()
    assert_scaled_close(y[:-1], y_plain[:-1], 1e-4)
    again = emulate(data, cols, x, f.launch_plan, "float32")
    np.testing.assert_array_equal(y.view(np.uint32), again.view(np.uint32))


# ------------------------------------------------------------- wrapper


def test_wrapper_takes_the_plain_version_on_the_cpu_with_or_without_a_plan(request):
    dense, _, f = _lowered("hetero_four", request)
    x = torch.from_numpy(_x(dense.shape[1]))
    before = fused_spmv.launches
    args = (f.data, f.cols, f.rows, f.tile_map, x, f.n_rows, f.tile)
    y0 = fused_spmv(*args)
    y1 = fused_spmv(*args, plan=f.launch_plan)
    assert fused_spmv.launches == before
    assert torch.equal(y0, y1) and torch.equal(y0[: f.n_rows], f(x))
    other = fused_launch_plan(f.rows.numpy()[: f.tile], np.zeros(1, np.int32), f.tile,
                              f.n_rows, H100_SMS)
    if f.n_tiles > 1:
        with pytest.raises(ValueError):  # a plan for another stream
            fused_spmv(*args, plan=other)
