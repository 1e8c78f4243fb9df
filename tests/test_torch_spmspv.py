"""SpMSpV, port vs reference: the ``CscEll`` container (exact), the
frontier-level wrapper (the port's plain version against the reference
kernel in interpret mode), the error contracts, the ``ops`` wiring and the
process memo, and ``AutoSpmvSession.compile_spmspv``. The same seeded numpy
inputs go to both packages; the port runs with ``device="cpu"``."""

import numpy as np
import pytest
import torch

import repro.sparse.registry as ref_registry
from repro.kernels import ops as ref_ops
from repro.kernels.common import InfeasibleConfig as RefInfeasible
from repro.kernels.common import KernelSchedule as RefSchedule
from repro.kernels.spmspv import _frontier_pad as ref_frontier_pad
from repro.kernels.spmspv import col_nnz as ref_col_nnz
from repro.kernels.spmspv import csc_from_dense as ref_csc_from_dense
from repro.kernels.spmspv import csc_spmspv as ref_csc_spmspv
from repro.kernels.spmspv import csc_spmspv_pallas as ref_csc_spmspv_pallas
from repro.sparse.generate import generate_by_name, random_matrix
import repro_torch.sparse.registry as registry
from repro_torch.core.autotuner import AutoSpMV
from repro_torch.core.session import AutoSpmvSession
from repro_torch.kernels import ops
from repro_torch.kernels.common import InfeasibleConfig, KernelSchedule
from repro_torch.kernels.spmspv import (
    CscEll,
    _frontier_pad,
    col_nnz,
    csc_from_dense,
    csc_spmspv,
    csc_spmspv_kernel,
    csc_spmspv_plain,
)

from torch_port_helpers import StubPredictor

CPU = torch.device("cpu")
WEB_SCALE = 0.0002  # webgraph at n = 175, as the reference's solver tests


def _matrix(n=96, avg=5.0, pattern="powerlaw", seed=0):
    if pattern == "webgraph":
        return generate_by_name("webgraph", scale=WEB_SCALE).astype(np.float32)
    return random_matrix(n, avg, pattern, seed=seed).astype(np.float32)


def _frontier(rng, n, k):
    active = rng.choice(n, size=k, replace=False).astype(np.int32) if k else (
        np.zeros(0, dtype=np.int32)
    )
    xvals = rng.standard_normal(k).astype(np.float32)
    return active, xvals


def _dense_ref(dense, active, xvals):
    x = np.zeros(dense.shape[1], dtype=np.float64)
    x[active] = xvals.astype(np.float64)
    return dense.astype(np.float64) @ x


@pytest.fixture
def clean_memo():
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()
    limit = ops.kernel_memo_limit()
    yield
    ops.set_kernel_memo_limit(limit)
    ops.clear_kernel_memo()
    ref_ops.clear_kernel_memo()


# ---------------------------------------------------------------- containers
@pytest.mark.parametrize("nnz_tile", [128, 256])
@pytest.mark.parametrize("pattern", ["powerlaw", "fem", "webgraph"])
def test_cscell_equals_reference_exactly(pattern, nnz_tile):
    dense = _matrix(pattern=pattern, seed=3)
    ref = ref_csc_from_dense(dense, RefSchedule(nnz_tile=nnz_tile))
    ours = csc_from_dense(dense, KernelSchedule(nnz_tile=nnz_tile), device="cpu")
    assert isinstance(ours, CscEll)
    for name in ("data", "rows"):
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.shape == ref.shape and ours.width == ref.width
    assert ours.nbytes == ref.nbytes
    assert ours.data.device == CPU and ours.rows.device == CPU
    np.testing.assert_array_equal(col_nnz(dense), ref_col_nnz(dense))
    assert col_nnz(dense).dtype == ref_col_nnz(dense).dtype


def test_padding_is_a_contiguous_tail_of_every_column():
    """The CUDA kernel stops a column at its first padding slot; that is
    only right because padding (row n_rows) is a tail, as here."""
    dense = _matrix(pattern="webgraph")
    mat = csc_from_dense(dense, device="cpu")
    n_rows, n_cols = mat.shape
    rows = mat.rows.numpy()
    counts = col_nnz(dense)
    for c in range(n_cols + 1):
        k = int(counts[c]) if c < n_cols else 0
        assert np.all(rows[c, :k] < n_rows) and np.all(rows[c, k:] == n_rows), c
    assert np.all(mat.data.numpy()[rows == n_rows] == 0)


@pytest.mark.parametrize("k", [0, 1, 7, 8, 9, 100, 128, 129, 4096])
def test_frontier_pad_equals_reference(k):
    assert _frontier_pad(k) == ref_frontier_pad(k)


# ------------------------------------------------------------ kernel parity
@pytest.mark.parametrize("occupancy", ["empty", "singleton", "half", "full"])
@pytest.mark.parametrize("pattern", ["powerlaw", "fem", "webgraph"])
def test_wrapper_matches_reference_kernel(occupancy, pattern):
    dense = _matrix(pattern=pattern, seed=3)
    n = dense.shape[1]
    k = {"empty": 0, "singleton": 1, "half": n // 2, "full": n}[occupancy]
    active, xvals = _frontier(np.random.default_rng(k), n, k)
    ref = np.asarray(ref_csc_spmspv(ref_csc_from_dense(dense), active, xvals))
    y = csc_spmspv(csc_from_dense(dense, device="cpu"), active, xvals)
    assert y.dtype == torch.float32 and y.shape == (dense.shape[0],) and y.device == CPU
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), _dense_ref(dense, active, xvals), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("unroll", [2, 4])
def test_unroll_variants_match_reference(unroll):
    dense = _matrix(seed=11)
    active, xvals = _frontier(np.random.default_rng(0), dense.shape[1], 23)
    ref = ref_csc_spmspv(ref_csc_from_dense(dense, RefSchedule(unroll=unroll)), active, xvals,
                         RefSchedule(unroll=unroll))
    sched = KernelSchedule(unroll=unroll)
    y = csc_spmspv(csc_from_dense(dense, sched, device="cpu"), active, xvals, sched)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_reversed_frontier_order_is_irrelevant():
    dense = _matrix(seed=5)
    active, xvals = _frontier(np.random.default_rng(7), dense.shape[1], 17)
    mat, ref_mat = csc_from_dense(dense, device="cpu"), ref_csc_from_dense(dense)
    fwd = csc_spmspv(mat, active, xvals).numpy()
    rev = csc_spmspv(mat, active[::-1], xvals[::-1]).numpy()
    np.testing.assert_allclose(fwd, rev, rtol=1e-6, atol=1e-6)
    ref_rev = np.asarray(ref_csc_spmspv(ref_mat, active[::-1], xvals[::-1]))
    np.testing.assert_allclose(rev, ref_rev, rtol=1e-5, atol=1e-5)


def test_bf16_both_packages_against_float64():
    dense = _matrix(seed=13)
    active, xvals = _frontier(np.random.default_rng(1), dense.shape[1], 31)
    ref64 = _dense_ref(dense, active, xvals)
    scale = np.abs(ref64).max() + 1e-9
    rs = RefSchedule(accum_dtype="bfloat16")
    ref = np.asarray(ref_csc_spmspv(ref_csc_from_dense(dense, rs), active, xvals, rs))
    sched = KernelSchedule(accum_dtype="bfloat16")
    y = csc_spmspv(csc_from_dense(dense, sched, device="cpu"), active, xvals, sched).numpy()
    assert np.abs(ref - ref64).max() / scale < 5e-2  # the reference test's own bound
    assert np.abs(y - ref64).max() / scale < 5e-2
    assert np.abs(y - ref64).max() / scale < 3e-2  # the port's stated bf16 tolerance


def test_kernel_level_call_with_spill_entries_matches_reference_pallas():
    """At the kernel level the frontier may hold entries that point at the
    spill column (the reference's power-of-two padding): they add zeros."""
    dense = _matrix(pattern="fem", seed=2)
    n_rows, n_cols = dense.shape
    active, xvals = _frontier(np.random.default_rng(3), n_cols, 5)
    k_pad = ref_frontier_pad(active.size)
    act = np.full(k_pad, n_cols, np.int32)
    xv = np.zeros(k_pad, np.float32)
    act[:5], xv[:5] = active, xvals
    xv[5:] = 3.0  # a nonzero x on a spill entry still contributes nothing
    ref_mat = ref_csc_from_dense(dense)
    ref = np.asarray(ref_csc_spmspv_pallas(ref_mat.data, ref_mat.rows, act, xv, n_rows,
                                           RefSchedule()))
    mat = csc_from_dense(dense, device="cpu")
    y = csc_spmspv_kernel(mat.data, mat.rows, mat.col_len, torch.from_numpy(act),
                          torch.from_numpy(xv), n_rows, KernelSchedule())
    assert y.shape == (n_rows + 1,) and float(y[n_rows]) == 0.0
    np.testing.assert_allclose(y.numpy()[:n_rows], ref[:n_rows], rtol=1e-5, atol=1e-5)
    plain = csc_spmspv_plain(mat.data, mat.rows, torch.from_numpy(act), torch.from_numpy(xv),
                             n_rows, KernelSchedule())
    torch.testing.assert_close(plain, y, rtol=0, atol=0)


def test_no_plain_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device launches
    its kernel or raises (here: a meta tensor, which has no kernel)."""
    mat = csc_from_dense(_matrix(seed=1), device="cpu")
    data, rows, col_len = mat.data.to("meta"), mat.rows.to("meta"), mat.col_len.to("meta")
    act = torch.zeros(1, dtype=torch.int32, device="meta")
    xv = torch.ones(1, dtype=torch.float32, device="meta")
    before = csc_spmspv.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        csc_spmspv_kernel(data, rows, col_len, act, xv, mat.shape[0], KernelSchedule())
    assert csc_spmspv.launches == before  # CPU and refused calls never count
    csc_spmspv(mat, np.array([0], np.int32), np.array([1.0], np.float32))
    assert csc_spmspv.launches == before


# ----------------------------------------------------------- error contracts
def test_frontier_validation_raises_like_the_reference():
    dense = _matrix(seed=29)
    mat, ref_mat = csc_from_dense(dense, device="cpu"), ref_csc_from_dense(dense)
    bad = [
        (np.array([dense.shape[1]], np.int32), np.array([1.0], np.float32)),
        (np.array([-1], np.int32), np.array([1.0], np.float32)),
        (np.array([0, 1], np.int32), np.array([1.0], np.float32)),
    ]
    for active, xvals in bad:
        with pytest.raises(ValueError):
            ref_csc_spmspv(ref_mat, active, xvals)
        with pytest.raises(ValueError):
            csc_spmspv(mat, active, xvals)


def test_misaligned_width_raises_infeasible_in_both():
    dense = _matrix(seed=19)  # max column nnz well under 128: W = 128
    mat = csc_from_dense(dense, KernelSchedule(nnz_tile=128), device="cpu")
    ref_mat = ref_csc_from_dense(dense, RefSchedule(nnz_tile=128))
    assert mat.width == ref_mat.width == 128
    one = (np.array([0], np.int32), np.array([1.0], np.float32))
    with pytest.raises(RefInfeasible):
        ref_csc_spmspv(ref_mat, *one, RefSchedule(nnz_tile=256))
    with pytest.raises(InfeasibleConfig):
        csc_spmspv(mat, *one, KernelSchedule(nnz_tile=256))
    # an empty frontier returns before any alignment check, in both
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    assert np.asarray(ref_csc_spmspv(ref_mat, *empty, RefSchedule(nnz_tile=256))).sum() == 0
    assert csc_spmspv(mat, *empty, KernelSchedule(nnz_tile=256)).sum() == 0


def test_storage_guard_reads_the_ports_bound(monkeypatch):
    dense = _matrix(seed=23)
    monkeypatch.setattr(registry, "MAX_STORAGE_BYTES", 1024)
    with pytest.raises(InfeasibleConfig):
        csc_from_dense(dense, device="cpu")
    ref_csc_from_dense(dense)  # the reference's own bound is untouched
    monkeypatch.setattr(ref_registry, "MAX_STORAGE_BYTES", 1024)
    with pytest.raises(RefInfeasible):
        ref_csc_from_dense(dense)


def test_spmspv_entry_requires_cscell():
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    with pytest.raises(TypeError):
        ref_ops.spmspv(object(), *empty)
    with pytest.raises(TypeError):
        ops.spmspv(object(), *empty)


# -------------------------------------------------------------- memo + ops
def test_compile_spmspv_memoizes_with_the_device_in_the_key(clean_memo):
    dense = _matrix(seed=31)
    fp = ops.matrix_fingerprint(dense)
    assert fp == ref_ops.matrix_fingerprint(dense)
    counts = []
    for mod, kw, sched in ((ref_ops, {}, RefSchedule), (ops, {"device": "cpu"}, KernelSchedule)):
        before = mod.kernel_memo_stats()
        p1 = mod.compile_spmspv(dense, memo_key=fp, **kw)
        p2 = mod.compile_spmspv(dense, memo_key=fp, **kw)
        mid = mod.kernel_memo_stats()
        p3 = mod.compile_spmspv(dense, sched(unroll=2), memo_key=fp, **kw)
        after = mod.kernel_memo_stats()
        assert p1 is p2 and p3 is not p1
        counts.append((mid["compiles"] - before["compiles"], mid["hits"] - before["hits"],
                       after["compiles"] - mid["compiles"]))
    assert counts[0] == counts[1] == (1, 1, 1)
    assert (fp, ops._SPMSPV_TAG, KernelSchedule(), CPU) in ops._KERNEL_MEMO
    assert ops._SPMSPV_TAG == ref_ops._SPMSPV_TAG
    assert ops.kernel_memo_size() == 2
    # the SpMV memo entries of the same matrix are separate and unaffected
    assert not ops.kernel_memoized(fp, "csr", device="cpu")
    assert ops.evict_kernel_memo_format("csr") == 0 and ops.kernel_memo_size() == 2


def test_compile_spmspv_shares_the_lru_bound(clean_memo):
    ops.set_kernel_memo_limit(1)
    dense = _matrix(seed=31)
    before = ops.kernel_memo_stats()["evictions"]
    ops.compile_spmspv(dense, memo_key="a", device="cpu")
    ops.compile_spmspv(dense, memo_key="b", device="cpu")
    assert ops.kernel_memo_size() == 1
    assert ops.kernel_memo_stats()["evictions"] - before == 1


def test_prepared_spmspv_call_and_modeled_work_equal_reference(clean_memo):
    dense = _matrix(seed=37)
    ref_p = ref_ops.compile_spmspv(dense)
    ours = ops.compile_spmspv(dense, device="cpu")
    assert isinstance(ours, ops.PreparedSpmspv) and ours.device == CPU
    assert isinstance(ours.col_nnz, np.ndarray)  # host-side: pricing never touches the device
    rng = np.random.default_rng(4)
    x = np.zeros(dense.shape[1], dtype=np.float32)
    active = rng.choice(dense.shape[1], size=13, replace=False)
    x[active] = rng.standard_normal(13).astype(np.float32)
    y = ours(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_p(x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(), y.numpy(), rtol=0, atol=0)
    srt = np.sort(active).astype(np.int32)
    np.testing.assert_allclose(ours.call_frontier(srt, x[srt]).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert ours.modeled_work(srt) == ref_p.modeled_work(srt) == int(col_nnz(dense)[srt].sum())
    assert ops.PreparedSpmspv(ours.mat, ours.schedule, CPU).modeled_work(srt) == 0


def test_session_compile_spmspv_books_one_compile(clean_memo):
    sess = AutoSpmvSession(AutoSpMV(predictor=StubPredictor(KernelSchedule()), device="cpu"))
    dense = _matrix(pattern="webgraph")
    p1 = sess.compile_spmspv(dense)
    assert sess.stats.kernel_compiles == 1 and sess.stats.feature_extractions == 1
    assert p1.device == CPU and p1.mat.data.device == CPU
    p2 = sess.compile_spmspv(dense)
    assert p2 is p1 and sess.stats.kernel_compiles == 1
    sess.compile_spmspv(dense, KernelSchedule(nnz_tile=256))
    assert sess.stats.kernel_compiles == 2


def test_xvals_are_cast_to_float32_like_the_reference():
    dense = _matrix(seed=41)
    active, xvals = _frontier(np.random.default_rng(8), dense.shape[1], 11)
    x64 = xvals.astype(np.float64) * (1 + 1e-12)  # bits a float32 cast drops
    ref = np.asarray(ref_csc_spmspv(ref_csc_from_dense(dense), active, x64))
    mat = csc_from_dense(dense, device="cpu")
    y64, y32 = csc_spmspv(mat, active.astype(np.int64), x64), csc_spmspv(mat, active, xvals)
    assert y64.dtype == torch.float32
    torch.testing.assert_close(y64, y32, rtol=0, atol=0)
    np.testing.assert_allclose(y64.numpy(), ref, rtol=1e-6, atol=1e-6)
