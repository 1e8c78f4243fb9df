"""The host-side rules of kernels B6 (CSC SpMSpV) and B2 (ELL SpMV), on the
CPU: how each launch is planned from integers (``spmspv_launch_plan``,
``ell_launch_plan``); that B6's pieces cover every frontier column's
nonzeros once (``spmspv_pieces``) and that its column lengths are the
reference's column counts; the slots each kernel loads (``spmspv_slots_read``,
``ell_slots_read``) against a numpy emulation of its loop; and that summing
in each kernel's order gives the plain version's and the reference kernel's
product. Containers come from both packages' converters; no test launches a
kernel."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels import spmv_pallas
from repro.kernels.spmspv import _frontier_pad as ref_frontier_pad
from repro.kernels.spmspv import col_nnz as ref_col_nnz
from repro.kernels.spmspv import csc_from_dense as ref_csc_from_dense
from repro.kernels.spmspv import csc_spmspv_pallas as ref_csc_spmspv_pallas
from repro.sparse.generate import generate_by_name, random_matrix
from repro_torch.kernels.common import KernelSchedule, bf16_round
from repro_torch.kernels.ell import (
    ELL_LANE_GROUPS,
    ELL_TARGET_WARPS_PER_SM,
    ELL_WARPS_PER_CTA,
    ell_grid,
    ell_launch_plan,
    ell_live_width,
    ell_plan_choices,
    ell_slots_read,
    ell_spmv_plain,
)
from repro_torch.kernels.ops import prepare
from repro_torch.kernels.spmspv import (
    SPMSPV_CTA_WARPS,
    SPMSPV_FEW_LONG,
    SPMSPV_LANE_GROUPS,
    SPMSPV_SLOTS,
    SPMSPV_TARGET_WARPS_PER_SM,
    csc_from_dense,
    csc_spmspv_plain,
    served_plan,
    spmspv_grid,
    spmspv_launch_plan,
    spmspv_pieces,
    spmspv_slots_read,
)

from torch_port_helpers import SCHEDULE_KW, assert_scaled_close, tol_for

H100_SMS = 132
# (lanes per piece, piece slots) as chip_smoke.py sweeps them
LAUNCHES = ((4, 32), (8, 64), (16, 128), (32, 256), (32, 512), (32, 1024))
HUB_LENS = (1200, 1025, 1024, 513, 257, 256, 255, 0)  # the hub matrix's first columns


def _hub_matrix(n: int = 1200, seed: int = 0) -> np.ndarray:
    """n x n, a power-law matrix whose first columns are replaced by columns
    of ``HUB_LENS`` nonzeros: long, at and around the piece sizes, empty."""
    rng = np.random.default_rng(seed)
    d = random_matrix(n, 3.0, "powerlaw", seed=seed).astype(np.float32)
    for c, L in enumerate(HUB_LENS):
        d[:, c] = 0.0
        rows = rng.choice(n, size=L, replace=False)
        d[rows, c] = rng.normal(size=L).astype(np.float32) + 2.0
    return d


def _matrix(pattern: str, seed: int = 3) -> np.ndarray:
    if pattern == "webgraph":  # n = 175, as the reference's solver tests
        return generate_by_name("webgraph", scale=0.0002).astype(np.float32)
    if pattern == "hub":
        return _hub_matrix(seed=seed)
    return random_matrix(96, 5.0, pattern, seed=seed).astype(np.float32)


def _frontiers(n_cols: int, seed: int = 0):
    """Named frontiers: the longest columns, a random tenth, every column,
    and a padded one whose tail points at the spill column."""
    rng = np.random.default_rng(seed)
    k = max(n_cols // 10, 1)
    spill = np.full(ref_frontier_pad(k), n_cols, np.int32)
    spill[:k] = np.sort(rng.choice(n_cols, size=k, replace=False))
    return {"first_columns": np.arange(min(len(HUB_LENS), n_cols), dtype=np.int32),
            "tenth": np.sort(rng.choice(n_cols, size=k, replace=False)).astype(np.int32),
            "full": np.arange(n_cols, dtype=np.int32), "spill_padded": spill}


# ------------------------------------------------------------ B6's launch plan
def test_plans_are_integer_only_and_deterministic():
    lens = np.array(HUB_LENS + (3, 1, 0), np.int64)
    for lanes, piece in LAUNCHES + ((None, None),):
        a = spmspv_launch_plan(lens, H100_SMS, lanes, piece)
        b = spmspv_launch_plan(lens.astype(np.int32), np.int64(H100_SMS),
                               None if lanes is None else np.int32(lanes),
                               None if piece is None else np.int64(piece))
        assert a.keys() == b.keys()
        for key in a:
            if key == "pieces":
                assert a[key].dtype == b[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert type(a[key]) is int and a[key] == b[key], key
    with pytest.raises(ValueError):
        spmspv_launch_plan(lens.astype(np.float32), H100_SMS)
    for lanes, piece in ((32, 100), (32, 0), (8, 65), (2, 16)):  # not whole trips; no such G
        with pytest.raises(ValueError):
            spmspv_launch_plan(lens, H100_SMS, lanes, piece)
    for R, W in ((14016, 128), (64, 512), (8, 128), (0, 128), (1024, 256)):
        p = ell_launch_plan(R, W, H100_SMS)
        assert p == ell_launch_plan(np.int64(R), np.int32(W), np.int64(H100_SMS))
        assert all(type(v) is int for v in p.values())
    with pytest.raises(ValueError):
        ell_launch_plan(8, 128, 0)


@pytest.mark.parametrize("k", [1, 16, 140, 1401, 4224, 7005, 14011, 40000])
def test_spmspv_lanes_fill_the_card_from_the_frontier(k):
    """The most lanes per piece while the frontier's first pieces stay within
    one round of resident warps; a piece is one trip of the group."""
    plan = spmspv_launch_plan(np.full(k, 4, np.int32), H100_SMS)
    G = plan["lanes"]
    cap = SPMSPV_TARGET_WARPS_PER_SM * H100_SMS
    assert G == SPMSPV_LANE_GROUPS[0] or -(-k * G // 32) <= cap
    if G < SPMSPV_LANE_GROUPS[-1]:
        assert -(-k * 2 * G // 32) > cap
    assert plan["piece"] == G * SPMSPV_SLOTS and plan["extra"] == 0
    assert {1: 32, 1401: 32, 7005: 8, 14011: 4}.get(k, G) == G  # webgraph's frontiers


@pytest.mark.parametrize("launch", LAUNCHES, ids=lambda p: f"G{p[0]}_H{p[1]}")
@pytest.mark.parametrize("pattern", ["hub", "webgraph", "powerlaw"])
def test_pieces_cover_each_frontier_column_once(pattern, launch):
    lanes, piece = launch
    dense = _matrix(pattern)
    mat = csc_from_dense(dense, device="cpu")
    n_cols = dense.shape[1]
    for name, active in _frontiers(n_cols).items():
        lens = mat.col_len_host[active]
        plan = spmspv_launch_plan(lens, H100_SMS, lanes, piece)
        pieces = spmspv_pieces(lens, plan)
        assert pieces.shape == (active.size + plan["extra"], 3)
        assert plan["warps"] * 32 // lanes >= pieces.shape[0] > (plan["warps"] - 1) * 32 // lanes
        assert plan["extra"] == int((np.maximum(lens.astype(np.int64) - 1, 0) // piece).sum())
        assert np.all(pieces[:, 2] <= piece)
        for i in range(active.size):
            mine = pieces[pieces[:, 0] == i]
            slots = np.concatenate([np.arange(s, s + n) for _, s, n in mine])
            np.testing.assert_array_equal(np.sort(slots), np.arange(lens[i]), err_msg=name)
            if lens[i] <= piece:  # spill entries and empty columns: the first piece only
                assert mine.shape[0] == 1 and mine[0, 1] == 0
            assert np.all(mine[:, 1] % piece == 0)
        # the further pieces come first in launch order
        assert np.all(pieces[: plan["extra"], 1] > 0) and np.all(pieces[plan["extra"]:, 1] == 0)
        np.testing.assert_array_equal(pieces[plan["extra"]:, 0], np.arange(active.size))


@pytest.mark.parametrize("n_long", [0, 1, SPMSPV_FEW_LONG, SPMSPV_FEW_LONG + 1, 200])
def test_pieces_of_few_and_many_long_columns_agree(n_long):
    """The plan lists further pieces with a loop for a few long entries and
    with numpy for many: both give the rows of the rule, in entry order."""
    rng = np.random.default_rng(n_long)
    lens = rng.integers(0, 32, size=600).astype(np.int32)
    lens[rng.choice(600, size=n_long, replace=False)] = rng.integers(33, 3000, size=n_long)
    for lanes in SPMSPV_LANE_GROUPS:
        plan = spmspv_launch_plan(lens, H100_SMS, lanes)
        piece = plan["piece"]
        want = [(i, s) for i in range(lens.size) for s in range(piece, int(lens[i]), piece)]
        np.testing.assert_array_equal(plan["pieces"], np.array(want, np.int32).reshape(-1, 2))
        assert plan["pieces"].dtype == np.int32 and plan["pieces"].shape[1] == 2


def test_grid_covers_the_pieces_and_spreads_a_small_frontier():
    for lanes in SPMSPV_LANE_GROUPS:
        per_warp = 32 // lanes
        for k in (1, 13, 131, 132, 133, 1401, 14011):
            for extra in (0, 12):
                g = spmspv_grid(k, extra, lanes, lanes * SPMSPV_SLOTS, H100_SMS)
                pieces, wpc = k + extra, g["warps_per_cta"]
                assert g["warps"] == -(-pieces // per_warp) and wpc in SPMSPV_CTA_WARPS
                assert (g["ctas"] - 1) * wpc < g["warps"] <= g["ctas"] * wpc
                # the C entry point's rule, in pieces
                assert (g["ctas"] - 1) * wpc * per_warp < pieces <= g["ctas"] * wpc * per_warp
                if wpc > 1:  # every SM gets a CTA
                    assert g["ctas"] >= H100_SMS
                else:
                    assert g["warps"] < 2 * H100_SMS
    assert spmspv_grid(0, 0, 32, 256, H100_SMS)["ctas"] == 0


@pytest.mark.parametrize("pattern", ["powerlaw", "fem", "webgraph"])
def test_col_len_is_the_references_column_count(pattern):
    dense = _matrix(pattern)
    ref = ref_csc_from_dense(dense)
    mat = csc_from_dense(dense, device="cpu")
    want = np.append(ref_col_nnz(dense), 0)  # the spill column is empty
    np.testing.assert_array_equal(mat.col_len_host, want)
    np.testing.assert_array_equal(mat.col_len.numpy(), want)
    assert mat.col_len.dtype == torch.int32 and mat.col_len_host.dtype == np.int32
    # the live slots of the reference's own container, column by column
    np.testing.assert_array_equal((np.asarray(ref.rows) < dense.shape[0]).sum(axis=1), want)


@pytest.mark.parametrize("pattern", ["hub", "webgraph", "fem", "powerlaw"])
def test_served_plan_is_the_plan_and_skips_the_lengths_where_no_column_is_long(pattern):
    """``csc_spmspv``'s plan equals ``spmspv_launch_plan`` of the frontier's
    column lengths; where the container's width fits in the rule's piece it
    does not read them (a container whose lengths cannot be gathered still
    plans)."""
    dense = _matrix(pattern)
    mat = csc_from_dense(dense, device="cpu")
    for name, active in _frontiers(dense.shape[1]).items():
        want = spmspv_launch_plan(mat.col_len_host[active], H100_SMS)
        got = served_plan(mat, active, H100_SMS)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}: {key}")
        assert got["pieces"].dtype == np.int32 and got["pieces"].shape == (want["extra"], 2)
        if mat.width <= want["piece"]:
            blind = dataclasses.replace(mat, col_len_host=None)
            assert served_plan(blind, active, H100_SMS)["extra"] == 0
        else:
            assert pattern in ("hub", "webgraph"), (pattern, mat.width)


# --------------------------------------------------------- B6's loop, emulated
def b6_emulate(mat, active: np.ndarray, xvals: np.ndarray, plan: dict, bf16: bool):
    """``csrc/spmspv_csc.cu`` in numpy, piece by piece in launch order: the
    group's piece ``[start, min(start + piece, col_len[c]))`` in trips of
    ``lanes * SPMSPV_SLOTS`` slots, lane j loading slots ``t + u * lanes +
    j`` (u < SPMSPV_SLOTS) of a trip, one float32 add into y per loaded
    slot, in slot order. Returns (y, slots loaded per warp)."""
    n_rows = mat.shape[0]
    G = plan["lanes"]
    data, rows, col_len = mat.data.numpy(), mat.rows.numpy(), mat.col_len_host
    y = np.zeros(n_rows + 1, np.float32)
    trip = G * SPMSPV_SLOTS
    lane_slot = (np.arange(SPMSPV_SLOTS)[:, None] * G + np.arange(G)[None, :]).ravel()
    pieces = [(int(e), int(s)) for e, s in plan["pieces"]] + [(i, 0) for i in range(active.size)]
    loaded = np.zeros(plan["warps"] * (32 // G), np.int64)
    for q, (i, start) in enumerate(pieces):
        c = int(active[i])
        end = min(start + plan["piece"], int(col_len[c]))
        for t in range(start, end, trip):
            j = t + lane_slot
            j = j[j < end]
            loaded[q] += j.size
            v, x = torch.from_numpy(data[c, j]), torch.tensor(float(xvals[i]))
            p = bf16_round(bf16_round(v) * bf16_round(x)) if bf16 else v * x
            np.add.at(y, rows[c, j], p.numpy().astype(np.float32))
    return y, loaded.reshape(plan["warps"], 32 // G).sum(axis=1)


@pytest.mark.parametrize("launch", LAUNCHES + (None,), ids=lambda p: f"G{p[0]}_H{p[1]}" if p else "plan")
@pytest.mark.parametrize("pattern", ["hub", "webgraph"])
def test_b6_slots_read_match_the_emulated_loop(pattern, launch):
    dense = _matrix(pattern)
    mat = csc_from_dense(dense, device="cpu")
    rng = np.random.default_rng(1)
    for name, active in _frontiers(dense.shape[1]).items():
        xvals = rng.normal(size=active.size).astype(np.float32)
        lens = mat.col_len_host[active]
        plan = spmspv_launch_plan(lens, H100_SMS, *(launch or (None, None)))
        _, per_warp = b6_emulate(mat, active, xvals, plan, False)
        lengths = spmspv_pieces(lens, plan)[:, 2]
        want = np.zeros(per_warp.size * (32 // plan["lanes"]), np.int64)
        want[: lengths.size] = lengths
        np.testing.assert_array_equal(per_warp, want.reshape(per_warp.size, -1).sum(axis=1))
        assert spmspv_slots_read(lens, plan) == int(per_warp.sum()) == int(lens.sum())


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["hub", "fem", "webgraph"])
def test_b6_order_gives_the_plain_and_the_reference_product(pattern, accum):
    dense = _matrix(pattern)
    n_rows, n_cols = dense.shape
    sched, ref_sched = KernelSchedule(accum_dtype=accum), RefSchedule(accum_dtype=accum)
    mat = csc_from_dense(dense, sched, device="cpu")
    ref_mat = ref_csc_from_dense(dense, ref_sched)
    tol = tol_for(accum)
    rng = np.random.default_rng(2)
    fronts = _frontiers(n_cols)
    for name in ("first_columns", "tenth", "spill_padded"):
        active = fronts[name]
        xvals = rng.normal(size=active.size).astype(np.float32)
        xvals[active == n_cols] = 3.0  # a spill entry adds nothing, whatever its x
        x64 = np.zeros(n_cols, np.float64)
        real = active < n_cols
        x64[active[real]] = xvals[real]
        ref64 = dense.astype(np.float64) @ x64
        plan = spmspv_launch_plan(mat.col_len_host[active], H100_SMS, 8, 64)
        y, _ = b6_emulate(mat, active, xvals, plan, accum == "bfloat16")
        assert y[n_rows] == 0.0
        act, xv = torch.from_numpy(active), torch.from_numpy(xvals)
        plain = csc_spmspv_plain(mat.data, mat.rows, act, xv, n_rows, sched).numpy()
        k_pad = ref_frontier_pad(active.size)
        ref_act = np.full(k_pad, n_cols, np.int32)
        ref_xv = np.zeros(k_pad, np.float32)
        ref_act[: active.size], ref_xv[: active.size] = active, xvals
        ref = np.asarray(ref_csc_spmspv_pallas(ref_mat.data, ref_mat.rows, ref_act, ref_xv,
                                               n_rows, ref_sched))
        assert_scaled_close(y[:n_rows], plain[:n_rows], tol)
        assert_scaled_close(y[:n_rows], ref[:n_rows], tol)
        assert_scaled_close(y[:n_rows], ref64, tol)


# ------------------------------------------------------------ B2's launch plan
@pytest.mark.parametrize("W", [128, 512])
def test_ell_plan_covers_every_row_once_and_fills_the_card(W):
    for R in (8, 64, 1000, 14016, 60000):
        plan = ell_launch_plan(R, W, H100_SMS)
        G = plan["lanes"]
        # the most lanes per row within ~32 warps per SM
        assert G == ELL_LANE_GROUPS[0] or R * G <= ELL_TARGET_WARPS_PER_SM * 32 * H100_SMS
        if G < ELL_LANE_GROUPS[-1]:
            assert R * 2 * G > ELL_TARGET_WARPS_PER_SM * 32 * H100_SMS
        for p in ell_plan_choices(R, W, H100_SMS):
            rows_of = {}
            for warp in range(p["warps"]):
                for lane in range(32):
                    row = warp * (32 // p["lanes"]) + lane // p["lanes"]
                    if row < R:
                        rows_of.setdefault(row, []).append(lane % p["lanes"])
            assert sorted(rows_of) == list(range(R))  # every row, by one group
            assert all(sorted(v) == list(range(p["lanes"])) for v in rows_of.values())
            assert p["warps"] == p["ctas"] * ELL_WARPS_PER_CTA
            assert (p["ctas"] - 1) * p["rows_per_cta"] < R <= p["ctas"] * p["rows_per_cta"]
    rim = ell_launch_plan(14016, 128, H100_SMS)  # rim's planes at the default schedule
    assert rim["lanes"] == 8 and rim["ctas"] == 438
    assert [p["lanes"] for p in ell_plan_choices(14016, 128, H100_SMS)] == [8, 4, 16, 32]
    assert ell_grid(14016, 32)["rows_per_cta"] == 8


# --------------------------------------------------------- B2's loop, emulated
def _fma(a, b, acc, bf16):
    if bf16:
        return bf16_round(acc + bf16_round(bf16_round(a) * bf16_round(b)))
    return (a.double() * b.double() + acc.double()).float()


def _add(a, b, bf16):
    return bf16_round(a + b) if bf16 else a + b


def b2_emulate(data, cols, x, plan, unroll, bf16):
    """``csrc/spmv_ell.cu`` in torch, all rows at once: lane j of a row's
    group of G adds slots ``s0 + u * G + j`` into accumulator u, step by
    step, skipping padding and stopping after the step that holds a zero
    value (or the end of the planes); the accumulators folded in u order;
    the group's lanes added by a butterfly, halves first. Returns (y, plane
    slots loaded)."""
    R, W = data.shape
    G = plan["lanes"]
    step = G * unroll
    acc = torch.zeros((R, G, unroll))
    live = torch.ones(R, dtype=torch.bool)
    reads = 0
    for s0 in range(0, W, step):
        s = s0 + torch.arange(unroll)[None, :] * G + torch.arange(G)[:, None]  # (G, U)
        inside = s < W
        sc = torch.clamp(s, max=W - 1)
        d = torch.where(inside, data[:, sc], 0.0)  # (R, G, U)
        c = torch.where(inside, cols[:, sc].long(), 0)
        reads += int(live.sum()) * int(inside.sum())
        on = live[:, None, None] & (d != 0)
        acc = torch.where(on, _fma(d, x[c], acc, bf16), acc)
        live &= ~(d == 0).flatten(1).any(dim=1)
    v = acc[:, :, 0]
    for u in range(1, unroll):
        v = _add(v, acc[:, :, u], bf16)
    off = G // 2
    while off:
        v = _add(v, v[:, torch.arange(G) ^ off], bf16)
        off //= 2
    return v[:, 0], reads


@pytest.mark.parametrize("kw", SCHEDULE_KW, ids=lambda kw: "-".join(map(str, kw.values())) or "default")
def test_b2_order_gives_the_plain_and_the_reference_product(kw):
    dense = random_matrix(200, 9.0, "powerlaw", seed=4).astype(np.float32)
    dense[17, :150] = np.random.default_rng(5).normal(size=150) + 2.0  # a row past one step
    x = np.random.default_rng(6).normal(size=dense.shape[1]).astype(np.float32)
    sched, ref_sched = KernelSchedule(**kw), RefSchedule(**kw)
    mat = prepare(dense, "ell", sched, device="cpu")
    xt = torch.from_numpy(x)
    bf16 = sched.accum_dtype == "bfloat16"
    tol = tol_for(sched.accum_dtype)
    plain = ell_spmv_plain(mat.data, mat.cols, xt, sched).numpy()
    ref = np.asarray(spmv_pallas(ref_prepare(dense, "ell", ref_sched), x, ref_sched))
    R, W = mat.data.shape
    live = ell_live_width(mat.data)
    n = dense.shape[0]
    for plan in ell_plan_choices(R, W, H100_SMS):
        y, reads = b2_emulate(mat.data, mat.cols, xt, plan, sched.unroll, bf16)
        again, _ = b2_emulate(mat.data, mat.cols, xt, plan, sched.unroll, bf16)
        assert torch.equal(y, again)  # a fixed order: the same bits
        assert reads == ell_slots_read(live, W, plan, sched.unroll) < R * W
        assert_scaled_close(y.numpy(), plain, tol)
        assert_scaled_close(y[:n].numpy(), ref[:n], tol)
        assert_scaled_close(y[:n].numpy(), dense.astype(np.float64) @ x.astype(np.float64), tol)


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_b2_stop_reads_each_row_up_to_the_step_of_its_tail(unroll):
    """A row reads its steps up to the one that holds its first padding slot:
    the whole width for a full row, at least one step for an empty one."""
    dense = np.zeros((64, 300), np.float32)
    rng = np.random.default_rng(7)
    for r, L in enumerate([0, 1, 7, 8, 9, 31, 32, 33, 127, 128, 200, 256] * 5 + [0] * 4):
        dense[r, rng.choice(300, size=L, replace=False)] = rng.normal(size=L) + 2.0
    mat = prepare(dense, "ell", KernelSchedule(rows_per_block=8, nnz_tile=128), device="cpu")
    R, W = mat.data.shape
    live = ell_live_width(mat.data)
    for G in ELL_LANE_GROUPS:
        plan = ell_grid(R, G)
        S = G * unroll
        want = sum(min(W, (n // S + 1) * S) for n in live.tolist())
        _, reads = b2_emulate(mat.data, mat.cols, torch.ones(300), plan, unroll, False)
        assert ell_slots_read(live, W, plan, unroll) == reads == want
        assert want >= int(live.sum()) + int((live < W).sum())  # at least the first padding slot
