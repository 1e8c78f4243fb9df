"""Port vs reference: the kernel-facing API (``kernels/ops.py``) and the
format registry. Fingerprints, memo accounting and footprints are exact;
``y`` follows the kernel tests' scaled tolerances."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import matrix_fingerprint as ref_fingerprint
from repro.core.objectives import MatrixStats as RefStats
from repro.sparse import registry as ref_reg
from repro.sparse.generate import random_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.common import DEFAULT_SCHEDULE, InfeasibleConfig, KernelSchedule
from repro_torch.obs.metrics import get_metrics
from repro_torch.sparse import registry as reg

from torch_port_helpers import FORMATS, SCHEDULE_KW, assert_scaled_close, tol_for


def _dense(pattern="fem", n=150, avg=7.0, seed=3):
    return random_matrix(n, avg, pattern, seed=seed).astype(np.float32)


@pytest.fixture()
def clean_memo():
    ops.clear_kernel_memo()
    limit = ops.kernel_memo_limit()
    yield
    ops.set_kernel_memo_limit(limit)
    ops.clear_kernel_memo()


# ------------------------------------------------------------- fingerprints
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fingerprint_string_equal(dtype):
    dense = _dense().astype(dtype)
    assert ops.matrix_fingerprint(dense) == ref_fingerprint(dense)
    # layout does not matter, content does
    assert ops.matrix_fingerprint(np.asfortranarray(dense)) == ref_fingerprint(dense)
    other = dense.copy()
    other[0, 0] += 1.0
    assert ops.matrix_fingerprint(other) != ops.matrix_fingerprint(dense)
    assert ops.matrix_fingerprint(other) == ref_fingerprint(other)


# ------------------------------------------------------------------- memo
def test_memo_hits_compiles_and_metrics(clean_memo):
    dense = _dense()
    fp = ops.matrix_fingerprint(dense)
    s0 = ops.kernel_memo_stats()
    m_hits = get_metrics().counter("spmv_kernel_memo_hits_total").value
    m_comp = get_metrics().counter("spmv_kernel_memo_compiles_total").value
    assert not ops.kernel_memoized(fp, "csr", device="cpu")
    k1 = ops.compile_spmv(dense, "csr", device="cpu", memo_key=fp)
    assert ops.kernel_memoized(fp, "csr", device="cpu")
    k2 = ops.compile_spmv(dense, "csr", device="cpu", memo_key=fp)
    assert k1 is k2
    # another schedule or format is another entry
    k3 = ops.compile_spmv(dense, "csr", KernelSchedule(unroll=2), device="cpu", memo_key=fp)
    k4 = ops.compile_spmv(dense, "sell", device="cpu", memo_key=fp)
    assert k3 is not k1 and k4 is not k1
    s1 = ops.kernel_memo_stats()
    assert s1["compiles"] - s0["compiles"] == 3
    assert s1["hits"] - s0["hits"] == 1
    assert ops.kernel_memo_size() == 3
    assert get_metrics().counter("spmv_kernel_memo_hits_total").value - m_hits == 1
    assert get_metrics().counter("spmv_kernel_memo_compiles_total").value - m_comp == 3
    # un-keyed compiles are never memoized nor counted
    ops.compile_spmv(dense, "csr", device="cpu")
    assert ops.kernel_memo_stats() == s1 and ops.kernel_memo_size() == 3


def test_memo_key_carries_the_device(clean_memo):
    """A CPU entry must not answer for a CUDA request (and the other way
    round): the device sits where the reference keeps ``interpret``."""
    dense = _dense(n=64)
    fp = ops.matrix_fingerprint(dense)
    ops.compile_spmv(dense, "csr", device="cpu", memo_key=fp)
    (key,) = list(ops._KERNEL_MEMO)
    assert key == (fp, "csr", DEFAULT_SCHEDULE, torch.device("cpu"))
    assert (fp, "csr", DEFAULT_SCHEDULE, torch.device("cuda", 0)) not in ops._KERNEL_MEMO


def test_memo_lru_bound_and_evictions(clean_memo):
    ops.set_kernel_memo_limit(2)
    mats = [_dense(seed=s, n=48) for s in (1, 2, 3)]
    fps = [ops.matrix_fingerprint(m) for m in mats]
    ev0 = ops.kernel_memo_stats()["evictions"]
    for m, fp in zip(mats, fps):
        ops.compile_spmv(m, "csr", device="cpu", memo_key=fp)
    assert ops.kernel_memo_size() == 2
    assert ops.kernel_memo_stats()["evictions"] - ev0 == 1
    assert not ops.kernel_memoized(fps[0], "csr", device="cpu")  # oldest went
    assert ops.kernel_memoized(fps[2], "csr", device="cpu")
    with pytest.raises(ValueError):
        ops.set_kernel_memo_limit(0)


def test_evict_kernel_memo_format(clean_memo):
    dense = _dense(n=64)
    fp = ops.matrix_fingerprint(dense)
    for fmt in ("csr", "ell", "sell"):
        ops.compile_spmv(dense, fmt, device="cpu", memo_key=fp)
    assert ops.evict_kernel_memo_format("ell") == 1
    assert not ops.kernel_memoized(fp, "ell", device="cpu")
    assert ops.kernel_memoized(fp, "csr", device="cpu")
    assert ops.evict_kernel_memo_format("ell") == 0


def test_compile_spmv_block_composes_key(clean_memo):
    dense = _dense(n=96)
    fp = ops.matrix_fingerprint(dense)
    x = np.random.default_rng(0).normal(size=96).astype(np.float32)
    blk = ops.compile_spmv_block(dense, 32, 64, "csr", device="cpu", memo_key=fp)
    np.testing.assert_allclose(blk(x).numpy(), dense[32:64] @ x, rtol=1e-4, atol=1e-4)
    assert ops.kernel_memoized((fp, 32, 64), "csr", device="cpu")
    assert not ops.kernel_memoized(fp, "csr", device="cpu")


def test_unregister_evicts_and_reregister_restores(clean_memo):
    dense = _dense(n=64)
    fp = ops.matrix_fingerprint(dense)
    ops.compile_spmv(dense, "sell", device="cpu", memo_key=fp)
    spec = reg.get_format("sell")
    reg.unregister_format("sell")
    try:
        assert "sell" not in reg.format_names()
        assert not ops.kernel_memoized(fp, "sell", device="cpu")
        with pytest.raises(ValueError):
            ops.prepare(dense, "sell", device="cpu")
    finally:
        reg.register_format(spec)
    assert reg.format_names() == ("csr", "ell", "bell", "sell")


# --------------------------------------------------------------- registry
def test_registry_seed_state_matches_reference():
    assert reg.format_names() == ref_reg.format_names() == ("csr", "ell", "bell", "sell")
    assert reg.default_format() == ref_reg.default_format() == "csr"
    assert reg.MAX_STORAGE_BYTES == ref_reg.MAX_STORAGE_BYTES
    for fmt in FORMATS:
        a, b = reg.get_format(fmt), ref_reg.get_format(fmt)
        assert (a.name, a.priority) == (b.name, b.priority)
        assert a.container.__name__ == b.container.__name__
    with pytest.raises(ValueError):
        reg.get_format("coo")
    with pytest.raises(ValueError):
        reg.register_format(reg.get_format("csr"))  # duplicate without overwrite
    with pytest.raises(TypeError):
        reg.spec_for(object())


@pytest.mark.parametrize("fmt", FORMATS)
def test_contract_roundtrip_and_oracle(fmt):
    spec = reg.get_format(fmt)
    for pattern in ("fem", "powerlaw"):
        dense = _dense(pattern)
        mat = spec.from_dense(dense, device="cpu")
        assert reg.spec_for(mat) is spec
        np.testing.assert_array_equal(spec.to_dense(mat), dense)
        x = np.random.default_rng(1).normal(size=dense.shape[1]).astype(np.float32)
        y = spec.reference(mat, x).numpy()[: dense.shape[0]]
        np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_contract_misaligned_schedule_exact_or_infeasible(fmt):
    """spmv on storage prepared with a *different* schedule either computes
    the exact result or raises InfeasibleConfig — never silently corrupts."""
    dense = _dense()
    x = np.random.default_rng(2).normal(size=dense.shape[1]).astype(np.float32)
    mat = ops.prepare(dense, fmt, KernelSchedule(rows_per_block=16, nnz_tile=128), device="cpu")
    for kw in SCHEDULE_KW:
        sched = KernelSchedule(**kw)
        try:
            y = ops.spmv(mat, x, sched).numpy()
        except InfeasibleConfig:
            continue
        assert_scaled_close(y, dense.astype(np.float64) @ x, tol_for(sched.accum_dtype))


def test_storage_guard_raises_infeasible():
    with pytest.raises(InfeasibleConfig):
        reg.check_storage_bytes(reg.MAX_STORAGE_BYTES + 1, "ELL")
    reg.check_storage_bytes(reg.MAX_STORAGE_BYTES, "ELL")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sched_i", [0, 2, 4])
def test_footprint_equals_reference(fmt, sched_i):
    """Finite, non-negative, useful_flops == 2*nnz, and field for field the
    reference's numbers (the note text aside, which names each package's
    own hardware)."""
    kw = SCHEDULE_KW[sched_i]
    for pattern in ("fem", "powerlaw", "block"):
        dense = _dense(pattern)
        fp = reg.get_format(fmt).footprint(reg.MatrixStats(dense), KernelSchedule(**kw))
        ref = ref_reg.get_format(fmt).footprint(RefStats(dense), RefSchedule(**kw))
        a, b = dataclasses.asdict(fp), dataclasses.asdict(ref)
        a.pop("note"), b.pop("note")
        assert a == b
        nnz = int((dense != 0).sum())
        assert fp.useful_flops == 2.0 * nnz and fp.feasible
        for k, v in a.items():
            if k != "feasible":
                assert math.isfinite(v) and v >= 0.0, (k, v)


def test_footprint_stream_residency_matches_reference():
    dense = _dense("block")
    for fmt in FORMATS:
        s = dict(x_residency="stream")
        fp = reg.get_format(fmt).footprint(reg.MatrixStats(dense), KernelSchedule(**s))
        ref = ref_reg.get_format(fmt).footprint(RefStats(dense), RefSchedule(**s))
        assert fp.feasible == ref.feasible == (fmt == "bell")
        assert fp.hbm_bytes == ref.hbm_bytes


def test_matrix_stats_match_reference():
    dense = _dense("powerlaw", n=200)
    a, b = reg.MatrixStats(dense), RefStats(dense)
    assert (a.n_rows, a.n_cols, a.nnz, a.max_nnz) == (b.n_rows, b.n_cols, b.nnz, b.max_nnz)
    np.testing.assert_array_equal(a.row_counts, b.row_counts)
    assert a.block_occupancy(16, 128) == b.block_occupancy(16, 128)
    assert a.sell_storage(32, 128) == b.sell_storage(32, 128)
