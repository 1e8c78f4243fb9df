"""The host-side rules of kernels B8 (ELL SpMM) and B3 (SELL), on the CPU:
how each launch is planned from integers (``spmm_launch_plan``,
``sell_launch_plan``) and that the plan covers every row, slot and column
once; where each kernel stops reading (its padding rule, ``ell_live_width``
and ``sell_live_width``, and the reads it implies, ``spmm_slots_read`` and
``sell_slots_read``); and that summing in each kernel's fixed order gives
the plain version's and the reference kernel's product. Containers come
from both packages' converters; no test launches a kernel."""

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels import spmm_pallas, spmv_pallas
from repro.sparse.formats import ell_from_dense as ref_ell_from_dense
from repro.sparse.formats import sell_from_dense as ref_sell_from_dense
from repro.sparse.generate import random_matrix
from repro_torch.kernels.common import ROWS_PER_BLOCK_CHOICES, KernelSchedule, bf16_round
from repro_torch.kernels.ell import (
    SPMM_CHUNK,
    SPMM_SPLIT_CHOICES,
    SPMM_WARPS_PER_CTA,
    spmm_grid,
    ell_live_width,
    ell_spmm_plain,
    spmm_launch_plan,
    spmm_plan_choices,
    spmm_slots_read,
)
from repro_torch.kernels.ops import prepare
from repro_torch.kernels.sell import (
    SELL_CARRY_PRODUCTS,
    SELL_MAX_THREADS,
    SELL_ROW_THREADS,
    sell_grid,
    sell_launch_plan,
    sell_live_width,
    sell_plan_choices,
    sell_slots_read,
    sell_spmv_plain,
)
from repro_torch.sparse.formats import ell_from_dense, sell_from_dense

from torch_port_helpers import SCHEDULE_KW, assert_scaled_close, to_port, tol_for

H100_SMS = 132


def _pattern(name: str, n: int = 40, seed: int = 0) -> np.ndarray:
    """Test matrices of n x n: empty rows, a nonzero in column 0, one hub
    row, or a generated power-law matrix."""
    rng = np.random.default_rng(seed)
    if name == "powerlaw":
        return random_matrix(n, 6.0, "powerlaw", seed=seed).astype(np.float32)
    d = np.zeros((n, n), np.float32)
    for r in range(n):
        if name == "empty_rows" and r % 3 == 0:
            continue
        cc = rng.choice(n, size=rng.integers(1, 6), replace=False)
        d[r, cc] = rng.normal(size=cc.size) + 2.0
    if name == "column_zero":
        d[::2, 0] = 1.5
    elif name == "hub_row":
        d[n // 2, :] = rng.normal(size=n) + 2.0
    return d


PATTERNS = ("empty_rows", "column_zero", "hub_row", "powerlaw")


# ------------------------------------------------------------ B8's launch plan
def _spmm_index_map(R: int, W: int, k: int, plan: dict):
    """B8's index maps as ``csrc/spmm_ell.cu`` computes them: {row: [(warp's
    piece, its chunk range)]}, the slot order of a chunk, the columns."""
    G, V, wpr, rpw = plan["lanes"], plan["vec"], plan["warps_per_row"], plan["rows_per_warp"]
    rows_at_once = SPMM_WARPS_PER_CTA // wpr
    n_chunks = -(-W // SPMM_CHUNK)
    pieces = {}
    for cta in range(plan["ctas"]):
        for warp in range(SPMM_WARPS_PER_CTA):
            piece = warp % wpr
            first = cta * rows_at_once * rpw + warp // wpr
            for i in range(rpw):
                row = first + i * rows_at_once
                if row < R:
                    beg, end = n_chunks * piece // wpr, n_chunks * (piece + 1) // wpr
                    pieces.setdefault(row, []).append((piece, beg, end))
    groups = 32 // G
    slots = sorted(t * groups + g for t in range(G) for g in range(groups))
    cols = sorted(c0 + j * V + v for c0 in range(0, k, G * V) for j in range(G)
                  for v in range(V) if c0 + j * V < k)
    return pieces, slots, cols


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 16, 64, 200])
@pytest.mark.parametrize("rpb", ROWS_PER_BLOCK_CHOICES)
def test_spmm_plan_covers_every_row_slot_and_column_once(rpb, k):
    for rows, W in ((rpb, 128), (5 * rpb, 256), (1024, 256), (3072, 128)):
        R = -(-rows // rpb) * rpb
        plan = spmm_launch_plan(R, W, k, H100_SMS)
        assert plan == spmm_launch_plan(np.int64(R), np.int32(W), np.int64(k), int(H100_SMS))
        for p in spmm_plan_choices(R, W, k, H100_SMS):
            pieces, slots, cols = _spmm_index_map(R, W, k, p)
            assert sorted(pieces) == list(range(R))  # every row, by one group of warps
            chunks = -(-W // SPMM_CHUNK)
            for row, got in pieces.items():
                assert sorted(q for q, _, _ in got) == list(range(p["warps_per_row"]))
                covered = [c for _, b, e in sorted(got) for c in range(b, e)]
                assert covered == list(range(chunks))  # each chunk once, in warp order
            assert slots == list(range(SPMM_CHUNK))
            assert cols == list(range(k))  # each output column by one lane
            assert (p["ctas"] - 1) * p["rows_per_cta"] < R <= p["ctas"] * p["rows_per_cta"]
            if p["warps_per_row"] > 1:  # a split row's partial fits one pass
                assert p["passes"] == 1 and p["lanes"] * p["vec"] <= 128


@pytest.mark.parametrize("R,W,k,wpr", [
    (1024, 256, 16, 4), (1024, 256, 4, 4), (3072, 128, 4, 1), (14016, 128, 1, 1),
    (14016, 128, 64, 1), (64, 128, 3, 4), (8, 128, 200, 1), (256, 512, 16, 8),
])
def test_spmm_plan_fills_the_card_from_the_shape(R, W, k, wpr):
    plan = spmm_launch_plan(R, W, k, H100_SMS)
    assert plan["warps_per_row"] == wpr
    assert plan["vec"] == (4 if k % 4 == 0 else 1)
    assert plan["lanes"] * plan["vec"] >= min(k, 32 * plan["vec"])
    # several warps on every SM; one wave of at most 64 warps per SM
    assert plan["warps"] >= min(16 * H100_SMS, R * wpr)
    assert R * wpr <= 64 * H100_SMS * plan["rows_per_warp"]


# ------------------------------------------------------------ B3's launch plan
@pytest.mark.parametrize("mean_width", [1, 128, 512])
@pytest.mark.parametrize("C", list(ROWS_PER_BLOCK_CHOICES) + [1, 3, 24, 1000])
def test_sell_plan_covers_every_row_and_element_once(C, mean_width):
    for n_slices in (1, 7, 1750):
        plan = sell_launch_plan(n_slices, C, mean_width, H100_SMS)
        assert plan == sell_launch_plan(np.int64(n_slices), np.int32(C), mean_width, H100_SMS)
        for p in sell_plan_choices(n_slices, C, mean_width, H100_SMS):
            P, spc, threads = p["row_threads"], p["slices_per_cta"], p["threads"]
            assert threads % 32 == 0 and spc * P * C <= threads <= SELL_MAX_THREADS
            assert (p["ctas"] - 1) * spc < n_slices <= p["ctas"] * spc
            if n_slices > 7:
                continue  # the thread map below, on the small grids
            seen = {}
            for cta in range(p["ctas"]):
                for t in range(threads):
                    local, q, r = t // (P * C), (t % (P * C)) // C, t % C
                    s = cta * spc + local
                    if local < spc and s < n_slices:
                        seen.setdefault((s, r), []).append(q)
            assert sorted(seen) == [(s, r) for s in range(n_slices) for r in range(C)]
            assert all(sorted(v) == list(range(P)) for v in seen.values())
            for width in (0, 1, 5, 128):  # thread q's elements q + j*P*U + u*P
                for U in (1, 2, 4, 8):
                    ks = sorted(j * P * U + u * P + q for q in range(P) for u in range(U)
                                for j in range(-(-width // (P * U)))
                                if j * P * U + u * P + q < width)
                    assert ks == list(range(width))


def test_sell_plan_fills_the_card_from_the_shape():
    rim = sell_launch_plan(219, 64, 128, H100_SMS)  # rim at C = 64
    assert rim["row_threads"] == 8 and rim["threads"] == 512 and rim["ctas"] == 219
    small = sell_launch_plan(1750, 8, 128, H100_SMS)  # C = 8: slices share CTAs
    assert small["slices_per_cta"] * 8 * small["row_threads"] >= 64
    assert sell_launch_plan(28, 512, 128, H100_SMS)["row_threads"] == 2  # P * C <= 1024
    assert sell_launch_plan(10, 64, 3, H100_SMS)["row_threads"] == 2  # P <= mean width
    for n_slices, C in ((219, 64), (1750, 8), (110, 128)):
        p = sell_launch_plan(n_slices, C, 512, H100_SMS)
        assert n_slices * C * p["row_threads"] <= 32 * 32 * H100_SMS
        if p["row_threads"] < SELL_ROW_THREADS[-1] and 2 * p["row_threads"] * C <= 1024:
            assert n_slices * C * 2 * p["row_threads"] > 32 * 32 * H100_SMS


# ------------------------------------------------------------ padding rules
def _ell(pkg: str, dense: np.ndarray, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    if pkg == "reference":
        m = ref_ell_from_dense(dense, min_width=width)
        return torch.from_numpy(np.array(m.data)), torch.from_numpy(np.array(m.cols))
    m = ell_from_dense(dense, min_width=width, device="cpu")
    return m.data, m.cols


def _sell(pkg: str, dense: np.ndarray, C: int, q: int):
    if pkg == "reference":
        m = ref_sell_from_dense(dense, C=C, q=q)
        return to_port("sell", m)
    return sell_from_dense(dense, C=C, q=q, device="cpu")


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_live_widths_are_the_row_lengths(pkg, pattern):
    dense = _pattern(pattern, seed=3)
    lengths = (dense != 0).sum(axis=1)
    for width in (1, 64, 128):
        data, cols = _ell(pkg, dense, width)
        live = ell_live_width(data)
        assert live.dtype == torch.int64
        np.testing.assert_array_equal(live.numpy(), lengths)
        for r, n in enumerate(live.tolist()):  # never read past the tail: all padding
            assert not data[r, n:].any() and not cols[r, n:].any()
    for C, q in ((8, 128), (32, 128), (3, 256)):
        mat = _sell(pkg, dense, C, q)
        live = sell_live_width(mat.data, mat.slice_ptr, mat.slice_width, C)
        padded = np.zeros(live.shape[0], np.int64)
        padded[: dense.shape[0]] = lengths  # the rows that fill the last slice are empty
        np.testing.assert_array_equal(live.numpy(), padded)


def _underflow_dense() -> np.ndarray:
    """float64 with a 1e-50 (0 in float32) before later nonzeros: in the hub
    row (40 nonzeros, so past the first 32-slot chunk) and in a short row."""
    dense = _pattern("hub_row", n=40, seed=11).astype(np.float64)
    dense[20, 5] = 1e-50  # row 20 is the hub row
    dense[3, :] = 0.0
    dense[3, [2, 9, 30]] = [1.0, 1e-50, 2.0]
    return dense


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_a_value_that_rounds_to_zero_is_not_stored_before_a_nonzero(fmt):
    """The port's converters choose nonzeros after the cast to float32, so no
    row stores a zero before a nonzero, and each kernel's stop rule
    (emulated) sums the whole row, as the plain version does."""
    dense = _underflow_dense()
    lengths = (dense.astype(np.float32) != 0).sum(axis=1)
    ref64 = dense.astype(np.float32).astype(np.float64)
    sched = KernelSchedule(rows_per_block=8, nnz_tile=128)
    tol = tol_for("float32")
    rng = np.random.default_rng(12)
    if fmt == "ell":
        mat = ell_from_dense(dense, min_width=128, device="cpu")
        np.testing.assert_array_equal(ell_live_width(mat.data).numpy(), lengths)
        X = torch.from_numpy(rng.normal(size=(40, 4)).astype(np.float32))
        plain = ell_spmm_plain(mat.data, mat.cols, X, sched)
        R, W = mat.data.shape
        for plan in spmm_plan_choices(R, W, 4, H100_SMS):
            Y, _ = b8_emulate(mat.data, mat.cols, X, plan, False)
            assert_scaled_close(Y.numpy(), plain.numpy(), tol)
            assert_scaled_close(Y.numpy(), ref64 @ X.double().numpy(), tol)
        return
    mat = sell_from_dense(dense, C=8, q=128, device="cpu")
    live = sell_live_width(mat.data, mat.slice_ptr, mat.slice_width, 8)
    np.testing.assert_array_equal(live.numpy(), lengths)
    x = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    plain = sell_spmv_plain(mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x, 8, sched)
    n_slices = mat.slice_width.shape[0]
    for plan in sell_plan_choices(n_slices, 8, 128, H100_SMS):
        y, _ = b3_emulate(mat, x, plan, 1, False)
        assert_scaled_close(y.numpy(), plain.numpy(), tol)
        assert_scaled_close(y.reshape(-1).numpy(), ref64 @ x.double().numpy(), tol)


# ------------------------------------------------ the kernels' order, emulated
def _fma(a, b, acc, bf16):
    if bf16:
        return bf16_round(acc + bf16_round(bf16_round(a) * bf16_round(b)))
    return (a.double() * b.double() + acc.double()).float()


def _add(a, b, bf16):
    return bf16_round(a + b) if bf16 else a + b


def b8_emulate(data, cols, X, plan, bf16):
    """``csrc/spmm_ell.cu`` in torch, all rows at once: per warp of a row
    its chunks in order, stopping after the chunk that holds a zero value;
    per lane group ``g`` the slots ``t * (32 / G) + g`` of each chunk, in t
    order, skipping padding; the butterfly over the group bits; the pieces
    in warp order. Returns (Y, plane slots read)."""
    R, W = data.shape
    G, wpr = plan["lanes"], plan["warps_per_row"]
    groups = 32 // G
    n_chunks = -(-W // SPMM_CHUNK)
    pad_to = n_chunks * SPMM_CHUNK
    d_all = torch.zeros((R, pad_to))
    c_all = torch.zeros((R, pad_to), dtype=torch.long)
    d_all[:, :W], c_all[:, :W] = data, cols.long()
    total, reads = None, 0
    for q in range(wpr):
        beg, end = n_chunks * q // wpr, n_chunks * (q + 1) // wpr
        acc = torch.zeros((R, groups, X.shape[1]))
        active = torch.ones(R, dtype=torch.bool)
        for ch in range(beg, end):
            d = d_all[:, ch * 32:(ch + 1) * 32]
            c = c_all[:, ch * 32:(ch + 1) * 32]
            reads += int(active.sum()) * min(32, W - ch * 32)
            for t in range(G):
                dt = d[:, t * groups:(t + 1) * groups]  # (R, groups)
                xt = X[c[:, t * groups:(t + 1) * groups]]  # (R, groups, k)
                on = (active[:, None] & (dt != 0))[:, :, None]
                acc = torch.where(on, _fma(dt[:, :, None], xt, acc, bf16), acc)
            active &= ~(d == 0).any(dim=1)
        off = 16
        while off >= G:
            acc = _add(acc, acc[:, torch.arange(groups) ^ (off // G)], bf16)
            off //= 2
        total = acc[:, 0] if total is None else _add(total, acc[:, 0], bf16)
    return total, reads


def b3_emulate(mat, x, plan, unroll, bf16, carry=SELL_CARRY_PRODUCTS):
    """``csrc/spmv_sell.cu`` in torch: thread (p, r) of slice s adds
    elements ``k = j*P*U + u*P + p`` into accumulator u (padding skipped),
    folds them in u order, and p = 0 adds the P partials in p order; the
    warps' stop rule counts the elements read. In bf16 a thread folds its
    accumulators into a float32 carry after each step that reaches a
    multiple of ``carry`` of the row's products (``None``: never, the
    kernel before the rule). Returns (y, elements read)."""
    C, P, spc, threads = mat.C, plan["row_threads"], plan["slices_per_cta"], plan["threads"]
    n_slices = mat.slice_width.shape[0]
    widths, ptr = mat.slice_width.tolist(), mat.slice_ptr.tolist()
    step = P * unroll
    y = torch.zeros(n_slices * C)
    reads = 0
    for cta in range(plan["ctas"]):
        lanes = []
        for t in range(threads):
            local, p, r = t // (P * C), (t % (P * C)) // C, t % C
            s = cta * spc + local
            ok = local < spc and s < n_slices
            lanes.append((ok, s, p, r, widths[s] if ok else 0))
        partial = {}
        for w0 in range(0, threads, 32):
            warp = lanes[w0:w0 + 32]
            wmax = max(lane[-1] for lane in warp)
            accs = [[torch.zeros(()) for _ in range(unroll)] for _ in warp]
            carries = [torch.zeros(()) for _ in warp]
            for k0 in range(0, wmax, step):
                last_live = False
                for i, (_, s, p, r, w) in enumerate(warp):
                    for u in range(unroll):
                        k = k0 + u * P + p
                        if k >= w:
                            continue
                        reads += 1
                        idx = ptr[s] + k * C + r
                        d = mat.data[idx]
                        if d != 0:
                            accs[i][u] = _fma(d, x[mat.cols[idx].long()], accs[i][u], bf16)
                        if u == unroll - 1 and d != 0:
                            last_live = True
                if k0 + step >= wmax or not last_live:
                    break
                if bf16 and carry is not None and (k0 + step) % carry < step:
                    for i, acc in enumerate(accs):
                        v = acc[0]
                        for u in range(1, unroll):
                            v = _add(v, acc[u], True)
                        carries[i] = carries[i] + v
                        accs[i] = [torch.zeros(()) for _ in range(unroll)]
            for i, (ok, s, p, r, _) in enumerate(warp):
                if ok:
                    v = accs[i][0]
                    for u in range(1, unroll):
                        v = _add(v, accs[i][u], bf16)
                    if bf16 and carry is not None:
                        v = _add(carries[i], v, True)
                    partial[(s, r, p)] = v
        for (s, r, p), v in partial.items():
            if p == 0:
                tot = v
                for q in range(1, P):
                    tot = _add(tot, partial[(s, r, q)], bf16)
                y[s * C + r] = tot
    return y.reshape(n_slices, C), reads


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("kw", SCHEDULE_KW, ids=lambda kw: "-".join(map(str, kw.values())) or "default")
def test_b8_order_gives_the_plain_and_the_reference_product(kw, k):
    dense = _pattern("hub_row", n=48, seed=k)
    X = np.random.default_rng(k).normal(size=(dense.shape[1], k)).astype(np.float32)
    sched, ref_sched = KernelSchedule(**kw), RefSchedule(**kw)
    mat = prepare(dense, "ell", sched, device="cpu")
    Xt = torch.from_numpy(X)
    bf16 = sched.accum_dtype == "bfloat16"
    tol = tol_for(sched.accum_dtype)
    plain = ell_spmm_plain(mat.data, mat.cols, Xt, sched)
    ref = np.asarray(spmm_pallas(ref_prepare(dense, "ell", ref_sched), X, ref_sched))
    R, W = mat.data.shape
    live = ell_live_width(mat.data)
    for plan in spmm_plan_choices(R, W, k, H100_SMS) + [
            spmm_grid(R, W, k, spmm_launch_plan(R, W, k, 1)["lanes"],
                       4 if k % 4 == 0 else 1, 8, 1)]:
        Y, reads = b8_emulate(mat.data, mat.cols, Xt, plan, bf16)
        assert reads == spmm_slots_read(live, W, plan)  # the host twin of the stop rule
        assert reads <= R * W
        assert_scaled_close(Y.numpy(), plain.numpy(), tol)
        assert_scaled_close(Y[: dense.shape[0]].numpy(), ref[: dense.shape[0]], tol)
        assert_scaled_close(Y[: dense.shape[0]].numpy(),
                            dense.astype(np.float64) @ X.astype(np.float64), tol)


def test_b8_stop_reads_only_the_chunks_up_to_the_tail():
    """At one warp per row the reads are each row's chunks up to the one that
    holds its first padding slot: all chunks for a full row."""
    dense = _pattern("hub_row", n=100, seed=1)
    mat = prepare(dense, "ell", KernelSchedule(rows_per_block=8, nnz_tile=128), device="cpu")
    R, W = mat.data.shape
    live = ell_live_width(mat.data)
    plan = spmm_grid(R, W, 1, 1, 1, 1, 1)
    want = sum(min(W, (n // 32 + 1) * 32) for n in live.tolist())
    assert spmm_slots_read(live, W, plan) == want < R * W
    for wpr in SPMM_SPLIT_CHOICES:  # a split reads at least as much
        assert spmm_slots_read(live, W, spmm_grid(R, W, 1, 1, 1, wpr, 1)) >= want


@pytest.mark.parametrize("pattern", ["hub_row", "powerlaw"])
@pytest.mark.parametrize("kw", SCHEDULE_KW, ids=lambda kw: "-".join(map(str, kw.values())) or "default")
def test_b3_order_gives_the_plain_and_the_reference_product(kw, pattern):
    dense = _pattern(pattern, n=40, seed=5)
    x = np.random.default_rng(2).normal(size=dense.shape[1]).astype(np.float32)
    sched, ref_sched = KernelSchedule(**kw), RefSchedule(**kw)
    mat = prepare(dense, "sell", sched, device="cpu")
    xt = torch.from_numpy(x)
    bf16 = sched.accum_dtype == "bfloat16"
    tol = tol_for(sched.accum_dtype)
    n = dense.shape[0]
    args = (mat.data, mat.cols, mat.slice_ptr, mat.slice_width, xt, mat.C, sched)
    plain = sell_spmv_plain(*args).reshape(-1)[:n]
    ref = np.asarray(spmv_pallas(ref_prepare(dense, "sell", ref_sched), x, ref_sched))
    n_slices = mat.slice_width.shape[0]
    live = sell_live_width(mat.data, mat.slice_ptr, mat.slice_width, mat.C)
    mean_width = mat.data.shape[0] / (n_slices * mat.C)
    for plan in sell_plan_choices(n_slices, mat.C, mean_width, H100_SMS)[:3]:
        y, reads = b3_emulate(mat, xt, plan, sched.unroll, bf16)
        assert reads == sell_slots_read(live, mat.slice_width, mat.C, plan, sched.unroll)
        assert int((mat.data != 0).sum()) <= reads <= mat.data.shape[0]
        y = y.reshape(-1)[:n]
        assert_scaled_close(y.numpy(), plain.numpy(), tol)
        assert_scaled_close(y.numpy(), ref, tol)
        assert_scaled_close(y.numpy(), dense.astype(np.float64) @ x.astype(np.float64), tol)


def test_b3_bf16_sums_fold_into_a_float32_carry_on_long_rows():
    """Rows of 640 positive products at one thread a row (C = 512 gives P <=
    2): one bf16 running sum stalls once its ulp passes the products (at 512
    a product below 2 rounds away), and leaves the 3e-2 bound; the kernel's
    sums of at most 128 products, collected in float32, stay within it, as
    the plain version's float32 sum rounded once does."""
    rng = np.random.default_rng(26)
    n, width = 8, 640
    dense = np.zeros((n, 1024), np.float32)
    for r in range(n):
        cols = rng.choice(1024, size=width, replace=False)
        dense[r, cols] = rng.uniform(0.5, 1.5, size=width)
    x = torch.from_numpy(rng.uniform(0.9, 1.1, size=1024).astype(np.float32))
    sched = KernelSchedule(rows_per_block=8, nnz_tile=128, accum_dtype="bfloat16")
    mat = sell_from_dense(dense, C=8, q=128, device="cpu")
    plain = sell_spmv_plain(mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x, 8, sched)
    exact = dense.astype(np.float64) @ x.double().numpy()
    plan = sell_grid(mat.slice_width.shape[0], 8, 1)
    y, _ = b3_emulate(mat, x, plan, 1, True)
    whole_row, _ = b3_emulate(mat, x, plan, 1, True, carry=None)
    tol = tol_for("bfloat16")
    assert_scaled_close(y.reshape(-1).numpy(), plain.reshape(-1).numpy(), tol)
    assert_scaled_close(y.reshape(-1).numpy(), exact, tol)
    err = np.abs(whole_row.reshape(-1).numpy() - exact).max() / np.abs(exact).max()
    assert err > tol


def test_b3_stop_reads_less_than_the_padded_slices():
    """FEM-like rows of ~6 nonzeros in slices padded to 128: the stop rule
    reads whole steps of P * U elements per row, so at steps of up to 32
    it reads less than half of what is stored, at a step of the width all."""
    dense = random_matrix(256, 6.0, "fem", seed=4).astype(np.float32)
    mat = sell_from_dense(dense, C=64, q=128, device="cpu")
    live = sell_live_width(mat.data, mat.slice_ptr, mat.slice_width, 64)
    nnz, stored = int((mat.data != 0).sum()), mat.data.shape[0]
    for P in SELL_ROW_THREADS:
        for U in (1, 4):
            read = sell_slots_read(live, mat.slice_width, 64, sell_grid(4, 64, P), U)
            assert nnz <= read <= stored
            if P * U <= 32:
                assert read < stored // 2
            if P * U == 128:
                assert read == stored


# --------------------------------------------- the one observable difference
def test_non_finite_x_zero_is_the_one_observable_difference():
    """With inf in X[0] / x[0], summing every stored slot (the reference and
    the plain versions) turns each padded row into NaN (0 * inf); B8 and B3
    gather nothing for a padding slot, so a padded row without a real
    nonzero in column 0 stays finite. Rows that hold column 0 are inf or
    NaN in both."""
    dense = _pattern("column_zero", n=40, seed=7)
    holds_0 = dense[:, 0] != 0
    # B8
    sched = KernelSchedule(rows_per_block=8, nnz_tile=128)
    mat = prepare(dense, "ell", sched, device="cpu")
    X = torch.ones((dense.shape[1], 4))
    X[0, 1] = float("inf")
    R, W = mat.data.shape
    Y_all = ell_spmm_plain(mat.data, mat.cols, X, sched)[: dense.shape[0]]
    Y_kernel, _ = b8_emulate(mat.data, mat.cols, X, spmm_launch_plan(R, W, 4, H100_SMS), False)
    Y_kernel = Y_kernel[: dense.shape[0]]
    assert torch.isnan(Y_all[~holds_0]).any(dim=1).all()  # every row is padded
    assert torch.isfinite(Y_kernel[~holds_0]).all()
    assert not torch.isfinite(Y_kernel[holds_0]).all(dim=1).any()
    assert not torch.isfinite(Y_all[holds_0]).all(dim=1).any()
    # B3
    smat = sell_from_dense(dense, C=8, q=128, device="cpu")
    x = torch.ones(dense.shape[1])
    x[0] = float("inf")
    y_all = sell_spmv_plain(smat.data, smat.cols, smat.slice_ptr, smat.slice_width, x, 8,
                            sched).reshape(-1)[: dense.shape[0]]
    plan = sell_launch_plan(smat.slice_width.shape[0], 8, 128, H100_SMS)
    y_kernel, _ = b3_emulate(smat, x, plan, 1, False)
    y_kernel = y_kernel.reshape(-1)[: dense.shape[0]]
    assert torch.isnan(y_all[~holds_0]).all() and torch.isfinite(y_kernel[~holds_0]).all()
    assert not torch.isfinite(y_kernel[holds_0]).any()
    assert not torch.isfinite(y_all[holds_0]).any()
