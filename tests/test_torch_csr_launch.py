"""The host-side rules of kernel B1 (CSR with hub rows split across the
card), on the CPU: how its launch is planned from integers
(``csr_launch_plan``); where each chunk CTA's k-ary search of ``indptr``
lands (emulated here in numpy) against the host twin ``csr_chunk_rows``;
that the row CTAs and the chunk CTAs between them add every nonzero once and
write every row once; and that summing in the kernel's fixed order (a warp
per short row, thread-strided sums and a fixed tree per hub part, the
pieces of a hub row added in chunk order) gives the plain version's and the
reference kernel's product. Containers come from both packages'
converters; no test launches a kernel."""

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels import spmv_pallas
from repro.sparse.generate import random_matrix
from repro_torch.kernels.common import ROWS_PER_BLOCK_CHOICES, UNROLL_CHOICES, KernelSchedule
from repro_torch.kernels.csr import (
    CSR_CARRY_PRODUCTS,
    CSR_CHUNK_PER_THREAD,
    CSR_CHUNK_ROWS,
    CSR_HUB_ROW,
    CSR_MAX_HUBS,
    CSR_MAX_THREADS,
    CSR_NO_HUB,
    CSR_ROUND,
    csr_chunk_rows,
    csr_hub_pieces,
    csr_launch_plan,
    csr_spmv_plain,
)
from repro_torch.kernels.ops import prepare

from torch_port_helpers import SCHEDULE_KW, assert_scaled_close, tol_for

H100_SMS = 132


def _pattern(name: str, n: int = 40, seed: int = 0) -> np.ndarray:
    """Test matrices: empty rows, one hub row of ``4 * n`` nonzeros, a
    power-law matrix, or all zeros."""
    rng = np.random.default_rng(seed)
    if name == "powerlaw":
        return random_matrix(n, 6.0, "powerlaw", seed=seed).astype(np.float32)
    if name == "all_zero":
        return np.zeros((n, n), np.float32)
    width = 4 * n if name == "hub_row" else n
    d = np.zeros((n, width), np.float32)
    for r in range(n):
        if name == "empty_rows" and r % 3 == 0:
            continue
        cc = rng.choice(width, size=rng.integers(1, 6), replace=False)
        d[r, cc] = rng.normal(size=cc.size) + 2.0
    if name == "hub_row":
        d[n // 2, :] = rng.normal(size=width) + 2.0
    return d


PATTERNS = ("empty_rows", "hub_row", "powerlaw", "all_zero")


def _indptr(dense: np.ndarray) -> np.ndarray:
    counts = (dense != 0).sum(axis=1)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _plans(n_rows: int, nnz: int) -> list[dict]:
    """The six schedules' plans, and small thresholds and chunks that make
    the test matrices' longer rows hub rows crossing several chunks."""
    plans = [csr_launch_plan(n_rows, nnz, KernelSchedule(**kw).rows_per_block,
                             KernelSchedule(**kw).unroll, H100_SMS) for kw in SCHEDULE_KW]
    return plans + [csr_launch_plan(n_rows, nnz, 8, 1, H100_SMS, hub_row=8, chunk=64),
                    csr_launch_plan(n_rows, nnz, 64, 2, H100_SMS, hub_row=4, chunk=32),
                    csr_launch_plan(n_rows, nnz, 16, 4, H100_SMS, hub_row=2, chunk=250)]


# ---------------------------------------------------------------- the plan
def test_each_schedule_maps_to_a_valid_distinct_launch():
    """The fields the kernel reads (``rows_per_block``, ``unroll``,
    ``accum_dtype``) give a distinct launch for every schedule of the six
    that differ in them; ``nnz_tile``, ``x_residency`` and
    ``dimension_semantics`` are not read."""
    seen = {}
    for kw in SCHEDULE_KW:
        s = KernelSchedule(**kw)
        plan = csr_launch_plan(14_011, 56_624, s.rows_per_block, s.unroll, H100_SMS)
        assert plan == csr_launch_plan(np.int64(14_011), np.int32(56_624),
                                       np.int64(s.rows_per_block), np.int32(s.unroll),
                                       np.int64(H100_SMS))
        launch = (plan["rows_per_cta"], plan["threads"], plan["unroll"], s.accum_dtype)
        seen[(s.rows_per_block, s.unroll, s.accum_dtype)] = launch
    assert len(set(seen.values())) == len(seen) == 5


@pytest.mark.parametrize("unroll", UNROLL_CHOICES)
@pytest.mark.parametrize("rpb", ROWS_PER_BLOCK_CHOICES)
def test_every_choice_gives_a_launch_that_covers_the_matrix(rpb, unroll):
    """Whole warps, at most 256 threads; the chunk CTAs cover the nonzeros
    and the row CTAs the rows, each with one CTA not full at most; about two
    chunk CTAs per SM where the chunk bounds allow, smaller chunks where a
    chunk would span more than CSR_CHUNK_ROWS rows; a chunk meets at most
    CSR_MAX_HUBS hub rows."""
    floor, lo, hi = CSR_CHUNK_PER_THREAD
    for n_rows, nnz in ((1, 0), (3_072, 157_286), (14_340, 8_810_000), (14_011, 56_624)):
        p = csr_launch_plan(n_rows, nnz, rpb, unroll, H100_SMS)
        assert p["threads"] == 32 * min(rpb, 8) <= CSR_MAX_THREADS
        per_thread = p["chunk"] // p["threads"]
        assert p["chunk"] == per_thread * p["threads"] and floor <= per_thread <= hi
        assert per_thread & (per_thread - 1) == 0
        spans = p["chunk"] * n_rows / max(nnz, 1)  # rows of a chunk, on average
        assert per_thread == floor or spans <= CSR_CHUNK_ROWS
        assert per_thread < lo or per_thread == hi or p["hub_ctas"] <= 2 * H100_SMS
        assert spans > CSR_CHUNK_ROWS / 2 or per_thread >= lo or nnz == 0
        assert p["hub_row"] == CSR_HUB_ROW
        assert (p["hub_ctas"] - 1) * p["chunk"] < nnz <= p["hub_ctas"] * p["chunk"] or nnz == 0
        assert (p["row_ctas"] - 1) * rpb < n_rows <= p["row_ctas"] * rpb
        assert p["ctas"] == p["hub_ctas"] + p["row_ctas"]
        assert p["chunk"] // p["hub_row"] + 2 <= CSR_MAX_HUBS
    # a low hub threshold keeps the chunk small enough to list its hub rows
    p = csr_launch_plan(14_340, 8_810_000, rpb, unroll, H100_SMS, hub_row=256)
    assert p["chunk"] // 256 + 2 <= CSR_MAX_HUBS


def test_no_chunk_cta_where_no_row_can_be_a_hub():
    """A row stores each column once, so with at most CSR_HUB_ROW columns no
    row is a hub: the plan launches no chunk CTA and the row CTAs skip no
    row (the LM's w_up, 1,024 columns); one more column brings them back."""
    p = csr_launch_plan(3_072, 157_286, 8, 8, H100_SMS, n_cols=1_024)
    assert (p["hub_row"], p["hub_ctas"], p["ctas"]) == (CSR_NO_HUB, 0, p["row_ctas"])
    q = csr_launch_plan(3_072, 157_286, 8, 8, H100_SMS, n_cols=1_025)
    assert q["hub_row"] == CSR_HUB_ROW and q["hub_ctas"] > 0
    assert csr_launch_plan(3_072, 157_286, 8, 8, H100_SMS, hub_row=256, n_cols=1_024)["hub_ctas"] > 0
    dense = _pattern("hub_row", n=48, seed=1)  # 192 columns, a row of 192
    x = np.random.default_rng(3).normal(size=dense.shape[1]).astype(np.float32)
    ptr, (rows, cols) = _indptr(dense), np.nonzero(dense)
    plan = csr_launch_plan(48, len(rows), 8, 2, H100_SMS, hub_row=192, n_cols=192)
    assert plan["hub_ctas"] == 0
    y, pieces = b1_emulate(ptr, cols, dense[rows, cols], x, plan, False)
    assert pieces == 0
    assert_scaled_close(y, dense.astype(np.float64) @ x.astype(np.float64), tol_for("float32"))


def test_the_plan_refuses_what_the_kernel_refuses():
    for kw in (dict(unroll=3), dict(hub_row=0), dict(chunk=0), dict(hub_row=100, chunk=20_000)):
        args = {"rows_per_block": 8, "unroll": 1, "n_sms": H100_SMS, **kw}
        with pytest.raises(ValueError):
            csr_launch_plan(100, 100, **args)


# ------------------------------------------- the search, emulated in numpy
def b1_search(ptr: np.ndarray, k: int, T: int) -> tuple[int, int, int, int]:
    """A chunk CTA's search, as ``csrc/spmv_csr.cu`` runs it with ``T``
    threads, for the row ``i = #{p : indptr[p + 1] <= k}`` that holds
    nonzero ``k``. Two brackets of it: set 0 probes a window of T rows
    around the row a uniform spread predicts (float32 arithmetic, as the
    kernel's), then strided rounds; set 1 probes T rows at a stride in the
    first round only. Each round searches the brackets' intersection.
    Returns (i, indptr[i], indptr[i + 1], rounds)."""
    n, nnz = len(ptr) - 1, int(ptr[-1])
    rows_per_nnz = np.float32(n) / np.float32(nnz)
    brackets = [[0, 0, n - 1, nnz], [0, 0, n - 1, nnz]]  # lo, indptr[lo], hi, indptr[hi + 1]
    lo, mlo, hi, mhi = 0, 0, n - 1, nnz
    rounds = 0
    while lo < hi:
        step = (hi - lo + T - 1) // T
        strided = [lo + (j + 1) * step - 1 for j in range(T)]
        sets = [strided]
        if rounds == 0:
            w = int(np.float32(k) * rows_per_nnz) - T // 2
            w = max(min(w, hi - T), lo)
            sets = [[w + j for j in range(T)], strided]
        for b, probes in zip(brackets, sets):
            probes = [p for p in probes if p < hi]
            below = sum(int(ptr[p + 1]) <= k for p in probes)
            if below > 0:
                b[0], b[1] = probes[below - 1] + 1, int(ptr[probes[below - 1] + 1])
            if below < len(probes):
                b[2], b[3] = probes[below], int(ptr[probes[below] + 1])
        lo, mlo = max((b[0], b[1]) for b in brackets)
        hi, mhi = min(((b[2], b[3]) for b in brackets), key=lambda h: h[0])
        rounds += 1
    return lo, mlo, mhi, rounds


def _chunk_rows(ptr: np.ndarray, plan: dict) -> tuple[list, list]:
    """Every chunk's (first row, last row) by the emulated search, held
    against the host twin; the search rounds each chunk took."""
    nnz, chunk, T = int(ptr[-1]), plan["chunk"], plan["threads"]
    rows, rounds = [], []
    for h in range(plan["hub_ctas"]):
        a = b1_search(ptr, h * chunk, T)
        b = b1_search(ptr, min((h + 1) * chunk, nnz) - 1, T)
        assert (a[1], a[2]) == (ptr[a[0]], ptr[a[0] + 1])
        assert ptr[a[0]] <= h * chunk < ptr[a[0] + 1]
        rows.append((a[0], b[0]))
        rounds.append(max(a[3], b[3]))
    twin_a, twin_b = csr_chunk_rows(torch.from_numpy(ptr.astype(np.int32)), plan)
    assert rows == list(zip(twin_a.tolist(), twin_b.tolist()))
    return rows, rounds


def _coverage(ptr: np.ndarray, plan: dict) -> dict:
    """Each nonzero is added once: a row of at most hub_row nonzeros by the
    row CTA that owns it, every other row in parts by the chunk CTAs whose
    search range holds it; each row is written once."""
    n, nnz, L, chunk = len(ptr) - 1, int(ptr[-1]), plan["hub_row"], plan["chunk"]
    lengths = np.diff(ptr)
    rows, rounds = _chunk_rows(ptr, plan)
    added = np.zeros(nnz, np.int64)
    writes = np.zeros(n, np.int64)
    for r in range(n):
        if lengths[r] <= L:
            added[ptr[r]:ptr[r + 1]] += 1
            writes[r] += 1
    pieces = {}
    for h, (ra, rb) in enumerate(rows):
        k0, k1 = h * chunk, min((h + 1) * chunk, nnz)
        for r in range(ra, rb + 1):
            if lengths[r] <= L:
                continue
            beg, end = max(ptr[r], k0), min(ptr[r + 1], k1)
            assert beg < end
            added[beg:end] += 1
            if ptr[r] >= k0 and ptr[r + 1] <= k1:
                writes[r] += 1
            else:
                pieces.setdefault(r, []).append(h)
    for r, hs in pieces.items():
        assert hs == list(range(ptr[r] // chunk, (ptr[r + 1] - 1) // chunk + 1))
        writes[r] += 1  # by the chunk that brings the last piece
    assert (added == 1).all() and (writes == 1).all()
    n_pieces = sum(len(hs) for hs in pieces.values())
    twin = csr_hub_pieces(torch.from_numpy(ptr.astype(np.int32)), plan)
    assert (twin["pieces"], twin["crossing_rows"]) == (n_pieces, len(pieces))
    assert twin["hub_rows"] == int((lengths > L).sum())
    return {"rounds": rounds, "pieces": n_pieces, "hubs_per_chunk": [
        int(sum(lengths[r] > L for r in range(ra, rb + 1))) for ra, rb in rows]}


@pytest.mark.parametrize("pattern", PATTERNS)
def test_every_nonzero_is_added_once_and_every_row_written_once(pattern):
    ptr = _indptr(_pattern(pattern, n=60, seed=3))
    for plan in _plans(len(ptr) - 1, int(ptr[-1])):
        out = _coverage(ptr, plan)
        assert max(out["hubs_per_chunk"], default=0) <= CSR_MAX_HUBS
        if pattern == "hub_row" and plan["chunk"] <= 64:
            assert out["pieces"] >= 4  # the hub row of 240 crosses chunks
        if pattern == "all_zero":
            assert plan["hub_ctas"] == 0 and out["pieces"] == 0


def test_an_empty_matrix_has_no_cta():
    plan = csr_launch_plan(0, 0, 64, 1, H100_SMS)
    assert plan["ctas"] == 0
    a, b = csr_chunk_rows(torch.zeros(1, dtype=torch.int32), plan)
    assert a.numel() == b.numel() == 0
    assert csr_hub_pieces(torch.zeros(1, dtype=torch.int32), plan)["pieces"] == 0


def _webgraph_indptr() -> np.ndarray:
    """``webgraph`` at n = 14,011 as ``sparse/generate`` draws it, without
    the 785 MB dense matrix: the same random stream, the (row, column)
    pairs deduplicated as the dense scatter collapses them."""
    from repro_torch.sparse import generate as gen

    spec = gen.SUITE["webgraph"]
    n = max(int(spec.n * 0.016), 64)
    got = {}

    def pairs(n_rows, n_cols, rows, cols, rng):
        got["rc"] = np.unique(rows * n_cols + cols)

    real = gen._scatter
    gen._scatter = pairs
    try:
        gen._PATTERNS["webgraph"](n, min(spec.avg_nnz, n / 2), np.random.default_rng(spec.seed))
    finally:
        gen._scatter = real
    counts = np.bincount(got["rc"] // n, minlength=n)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def test_webgraph_splits_its_hub_rows_across_chunks():
    """``webgraph@14011`` (the solve path's matrix): 56,624 nonzeros, rows of
    4.0 on average, a hub row of 4,252. At the served schedule (rows_per_block
    8, unroll 8) three rows are hub rows and 28 chunk CTAs of 2,048 nonzeros
    (about 507 rows each) add them; each chunk's search takes at most two
    rounds."""
    ptr = _webgraph_indptr()
    lengths = np.diff(ptr)
    assert len(ptr) - 1 == 14_011 and ptr[-1] == 56_624 and lengths.max() == 4_252
    for plan in _plans(len(ptr) - 1, int(ptr[-1])):
        out = _coverage(ptr, plan)
        assert max(out["rounds"]) <= 2
    served = csr_launch_plan(14_011, 56_624, 8, 8, H100_SMS)
    assert (served["threads"], served["chunk"], served["hub_ctas"], served["row_ctas"]) == (
        256, 2_048, 28, 1_752)
    assert csr_hub_pieces(torch.from_numpy(ptr.astype(np.int32)), served)["hub_rows"] == 3


# ------------------------------------------ the kernel's order, emulated
def _rnd(v: float) -> np.float32:
    """float32 -> bfloat16 (round to nearest even) -> float32."""
    u = int(np.float32(v).view(np.uint32))
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000) & 0xFFFFFFFF
    return np.uint32(u).view(np.float32)


def _add(a, b, bf16: bool) -> np.float32:
    s = np.float32(np.float32(a) + np.float32(b))
    return _rnd(s) if bf16 else s


def _prod(a, b, bf16: bool) -> np.float32:
    if bf16:
        return _rnd(np.float32(_rnd(a) * _rnd(b)))
    return np.float32(np.float32(a) * np.float32(b))


def _fma(a, b, acc, bf16: bool) -> np.float32:
    """Acc::fma: bf16 rounds operands, product and sum; float32 fuses."""
    if bf16:
        return _add(acc, _prod(a, b, True), True)
    return np.float32(np.float64(np.float32(a)) * np.float64(np.float32(b)) + np.float64(acc))


def _warp_tree(vals: list, bf16: bool) -> np.float32:
    """Lane 0 of ``spmv::warp_reduce``: shuffle-down offsets 16 .. 1."""
    v = list(vals) + [np.float32(0.0)] * (32 - len(vals))
    off = 16
    while off:
        for lane in range(off):
            v[lane] = _add(v[lane], v[lane + off], bf16)
        off //= 2
    return v[0]


def _fold(acc: list, bf16: bool) -> np.float32:
    """``spmv::fold``: a lane's accumulators added in order."""
    s = acc[0]
    for a in acc[1:]:
        s = _add(s, a, bf16)
    return s


def _block_sum(per_thread: list, bf16: bool) -> np.float32:
    """``block_sum``: a shuffle tree per warp, then the warps' sums as a
    pairwise tree (warp w and w + half, halves down to 1)."""
    w = [_warp_tree(per_thread[w0:w0 + 32], bf16) for w0 in range(0, len(per_thread), 32)]
    while len(w) > 1:
        half = (len(w) + 1) // 2
        w = [_add(w[i], w[i + half], bf16) if i + half < len(w) else w[i] for i in range(half)]
    return w[0]


def _combine(parts: list, T: int, bf16: bool) -> np.float32:
    """The last CTA's sum of a split row's pieces: thread t adds pieces t,
    t + T, ... in order, a shuffle tree sums each warp, thread 0 folds the
    warps in order."""
    sums = [np.float32(0.0)] * T
    for t in range(min(T, len(parts))):
        s = parts[t]
        for u in range(t + T, len(parts), T):
            s = _add(s, parts[u], bf16)
        sums[t] = s
    return _block_sum(sums, bf16)


def _stored(s, bf16: bool) -> np.float32:
    """y as the kernel stores it: bf16 rounds the float32 total once."""
    return _rnd(s) if bf16 else np.float32(s)


def b1_emulate(ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray, x: np.ndarray,
               plan: dict, bf16: bool) -> tuple[np.ndarray, int]:
    """``csrc/spmv_csr.cu`` in numpy. Row CTAs: per short row the lanes'
    ``unroll`` accumulators in trip order, folded, a shuffle tree. Chunk
    CTAs: the emulated search, each hub row's part summed per thread (each
    round of CSR_ROUND products a pairwise tree, the rounds in order) and by
    ``block_sum``, the pieces of a row that crosses chunks added in chunk
    order when the last one is in. bf16: a lane folds its accumulators into a
    float32 carry after each trip that reaches a multiple of
    CSR_CARRY_PRODUCTS of the row's products, a chunk thread adds its bf16
    products in float32, the trees and the pieces add float32 and y is
    rounded once. Returns (y, pieces)."""
    n, nnz = len(ptr) - 1, len(vals)
    T, L, chunk, U = plan["threads"], plan["hub_row"], plan["chunk"], plan["unroll"]
    y = np.full(n, np.nan, np.float32)
    for r in range(n):
        beg, end = int(ptr[r]), int(ptr[r + 1])
        if end - beg > L:
            continue
        lanes = []
        for lane in range(32):
            acc, carry = [np.float32(0.0)] * U, np.float32(0.0)
            for k in range(beg + lane, end, 32 * U):
                for u in range(U):
                    kk = k + u * 32
                    if kk < end:
                        acc[u] = _fma(vals[kk], x[cols[kk]], acc[u], bf16)
                if bf16 and (k - beg - lane + 32 * U) % CSR_CARRY_PRODUCTS < 32 * U:
                    carry = _add(carry, _fold(acc, True), False)
                    acc = [np.float32(0.0)] * U
            s = _fold(acc, bf16)
            lanes.append(_add(s, carry, False) if bf16 else s)
        y[r] = _stored(_warp_tree(lanes, False), bf16)
    end_part, start_part, tickets, pieces = {}, {}, {}, 0
    for h in range(plan["hub_ctas"]):
        k0, k1 = h * chunk, min((h + 1) * chunk, nnz)
        ra = b1_search(ptr, k0, T)[0]
        rb = b1_search(ptr, k1 - 1, T)[0]
        crossing = []
        for r in range(ra, rb + 1):
            rbeg, rend = int(ptr[r]), int(ptr[r + 1])
            if rend - rbeg <= L:
                continue
            beg, end = max(rbeg, k0), min(rend, k1)
            per_thread = []
            for t in range(T):
                acc = np.float32(0.0)
                for k in range(beg + t, end, T * CSR_ROUND):  # a round: a pairwise tree
                    pr = [_prod(vals[kk], x[cols[kk]], bf16) if kk < end else np.float32(0.0)
                          for kk in range(k, k + T * CSR_ROUND, T)]
                    w = CSR_ROUND // 2
                    while w:  # bf16: the products are added in float32
                        pr = [_add(pr[u], pr[u + w], False) for u in range(w)] + pr[w:]
                        w //= 2
                    acc = _add(acc, pr[0], False)
                per_thread.append(acc)
            s = _block_sum(per_thread, False)
            if rbeg >= k0 and rend <= k1:
                y[r] = _stored(s, bf16)
            elif rend <= k1:
                start_part[h] = s
                crossing.append(r)
            else:
                end_part[h] = s
                crossing.append(r)
        for r in crossing:
            pieces += 1
            a, b = int(ptr[r]) // chunk, (int(ptr[r + 1]) - 1) // chunk
            tickets[a] = tickets.get(a, 0) + 1
            if tickets[a] == b - a + 1:  # the last piece is in
                y[r] = _stored(_combine([end_part[u] for u in range(a, b)] + [start_part[b]], T,
                                        False), bf16)
                del tickets[a]
    assert not tickets  # every crossing row was added up
    return y, pieces


@pytest.mark.parametrize("pattern", ("empty_rows", "hub_row", "powerlaw"))
@pytest.mark.parametrize("kw", SCHEDULE_KW, ids=lambda kw: "-".join(map(str, kw.values())) or "default")
def test_b1_order_gives_the_plain_and_the_reference_product(kw, pattern):
    dense = _pattern(pattern, n=48, seed=5)
    x = np.random.default_rng(2).normal(size=dense.shape[1]).astype(np.float32)
    sched, ref_sched = KernelSchedule(**kw), RefSchedule(**kw)
    mat = prepare(dense, "csr", sched, device="cpu")
    bf16 = sched.accum_dtype == "bfloat16"
    tol = tol_for(sched.accum_dtype)
    ptr, cols, vals = (mat.indptr.numpy().astype(np.int64), mat.indices.numpy(),
                       mat.data.numpy())
    plain = csr_spmv_plain(mat.data, mat.indices, mat.indptr, torch.from_numpy(x), sched)
    ref = np.asarray(spmv_pallas(ref_prepare(dense, "csr", ref_sched), x, ref_sched))
    ref64 = dense.astype(np.float64) @ x.astype(np.float64)
    n, nnz = dense.shape[0], len(vals)
    rpb, U = sched.rows_per_block, sched.unroll
    for plan in (csr_launch_plan(n, nnz, rpb, U, H100_SMS),
                 csr_launch_plan(n, nnz, rpb, U, H100_SMS, 8, 64),
                 csr_launch_plan(n, nnz, 8, U, H100_SMS, 2, 100)):
        y, pieces = b1_emulate(ptr, cols, vals, x, plan, bf16)
        assert np.isfinite(y).all()  # every row written
        assert pieces == csr_hub_pieces(mat.indptr, plan)["pieces"]
        if pattern == "hub_row" and plan["chunk"] <= 64:
            assert pieces >= 3
        assert_scaled_close(y, plain.numpy(), tol)
        assert_scaled_close(y, ref, tol)
        assert_scaled_close(y, ref64, tol)
        assert (y[np.diff(ptr) == 0] == 0).all()  # an empty row stores an exact zero


def test_b1_bf16_error_on_a_hub_row_is_below_one_running_sum():
    """A row of 4,000 nonzeros in bf16 is a hub row: the chunk CTAs' blocked
    sums (per thread, a tree, the pieces in chunk order) against the float64
    product, beside one sequential bf16 running sum over the same products
    (what a single accumulator gives)."""
    rng = np.random.default_rng(11)
    n_cols = 4_000
    dense = np.zeros((3, n_cols), np.float32)
    dense[1] = rng.uniform(0.1, 1.0, size=n_cols)
    dense[0, :5] = dense[2, -5:] = 1.0
    x = rng.uniform(0.5, 1.5, size=n_cols).astype(np.float32)
    ptr, cols = _indptr(dense), np.nonzero(dense)[1]
    vals = dense[np.nonzero(dense)]
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    run = np.float32(0.0)
    for k in range(ptr[1], ptr[2]):
        run = _add(run, _prod(vals[k], x[cols[k]], True), True)
    running_err = abs(float(run) - ref[1]) / np.abs(ref).max()
    for chunk in (8_192, 1_024, 512):
        plan = csr_launch_plan(3, len(vals), 8, 8, H100_SMS, chunk=chunk)
        y, pieces = b1_emulate(ptr, cols, vals, x, plan, True)
        # the row holds nonzeros 5 .. 4,004
        assert pieces == (0 if chunk > 4_004 else 4_004 // chunk - 5 // chunk + 1)
        err = abs(float(y[1]) - ref[1]) / np.abs(ref).max()
        assert err < running_err / 4 and err < 3e-2
    assert running_err > 3e-2  # one running sum would fail the tolerance


@pytest.mark.parametrize("unroll", UNROLL_CHOICES)
def test_b1_bf16_row_path_folds_into_a_float32_carry(unroll):
    """A row of 1,000 nonzeros is short (a row warp adds it): in bf16 its
    lanes fold their sums into float32 carries every CSR_CARRY_PRODUCTS of
    its products, so its error is that of the products and of y's one
    rounding, far below one sequential bf16 running sum's."""
    rng = np.random.default_rng(12)
    n_cols = 1_000
    dense = np.zeros((2, n_cols), np.float32)
    dense[0] = rng.uniform(0.1, 1.0, size=n_cols)
    dense[1, :7] = 1.0
    x = rng.uniform(0.5, 1.5, size=n_cols).astype(np.float32)
    ptr, cols = _indptr(dense), np.nonzero(dense)[1]
    vals = dense[np.nonzero(dense)]
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    run = np.float32(0.0)
    for k in range(ptr[0], ptr[1]):
        run = _add(run, _prod(vals[k], x[cols[k]], True), True)
    running_err = abs(float(run) - ref[0]) / np.abs(ref).max()
    plan = csr_launch_plan(2, len(vals), 8, unroll, H100_SMS, n_cols=n_cols)
    assert plan["hub_ctas"] == 0  # 1,000 columns: no row can be a hub
    y, _ = b1_emulate(ptr, cols, vals, x, plan, True)
    err = abs(float(y[0]) - ref[0]) / np.abs(ref).max()
    assert err < 2.0**-8 and err < running_err / 4
    assert y[0] == _rnd(y[0])  # stored as bf16
