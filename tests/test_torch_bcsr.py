"""The BCSR plugin, port vs reference: storage, prepare, footprint, the
kernel's plain version against the reference's Pallas kernel (interpret
mode), the misalignment and storage-guard contracts, and registration.

Importing either package's BCSR module registers the format, so every test
that touches it takes ``with_bcsr``, which registers it in both packages and
unregisters it in both afterwards."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels import spmv_pallas
from repro.sparse.generate import random_matrix
from repro_torch.kernels import InfeasibleConfig, KernelSchedule, compile_spmv, prepare, spmv
from repro_torch.kernels.bcsr import bcsr_spmv, bcsr_spmv_plain

from torch_port_helpers import (
    PATTERNS,
    SCHEDULE_KW,
    assert_same_storage,
    assert_scaled_close,
    to_port,
    tol_for,
    with_bcsr,  # noqa: F401  (fixture)
)


def _dense(pattern="powerlaw", n=200, avg=6.0, seed=4):
    return random_matrix(n, avg, pattern, seed=seed).astype(np.float32)


@pytest.mark.parametrize("sched_i", range(len(SCHEDULE_KW)))
@pytest.mark.parametrize("pattern", ["fem", "powerlaw", "block"])
def test_prepare_storage_identical(with_bcsr, pattern, sched_i):
    from repro.sparse.bcsr import _bcsr_prepare as ref_bcsr_prepare
    from repro_torch.sparse.bcsr import _bcsr_prepare

    kw = SCHEDULE_KW[sched_i]
    dense = _dense(pattern, n=230)
    ref_mat = ref_bcsr_prepare(dense, RefSchedule(**kw))
    mat = _bcsr_prepare(dense, KernelSchedule(**kw), device="cpu")
    assert_same_storage("bcsr", ref_mat, mat)
    assert mat.n_blocks == ref_mat.n_blocks and mat.n_block_rows == ref_mat.n_block_rows
    assert (mat.nbytes, mat.nbytes_core) == (ref_mat.nbytes, ref_mat.nbytes_core)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_roundtrip_exact_and_equal_to_reference(with_bcsr, pattern):
    from repro.sparse.bcsr import bcsr_from_dense as ref_from, bcsr_to_dense as ref_to
    from repro_torch.sparse.bcsr import bcsr_from_dense, bcsr_to_dense

    dense = _dense(pattern, n=150)
    for br in (8, 64):
        mat = bcsr_from_dense(dense, br=br, pad_blocks_to=4, device="cpu")
        assert_same_storage("bcsr", ref_from(dense, br=br, pad_blocks_to=4), mat)
        np.testing.assert_array_equal(bcsr_to_dense(mat), dense)
        np.testing.assert_array_equal(bcsr_to_dense(mat), ref_to(ref_from(dense, br=br)))


@pytest.mark.parametrize("sched_i", range(len(SCHEDULE_KW)))
def test_spmv_matches_reference_kernel(with_bcsr, sched_i):
    """The port on the reference's prepared storage against the reference's
    Pallas kernel (interpret mode) and the float64 product."""
    kw = SCHEDULE_KW[sched_i]
    dense = _dense("block", n=260, avg=9.0, seed=3)
    x = np.random.default_rng(1).normal(size=dense.shape[1]).astype(np.float32)
    ref_sched, sched = RefSchedule(**kw), KernelSchedule(**kw)
    ref_mat = ref_prepare(dense, "bcsr", ref_sched)
    y_ref = np.asarray(spmv_pallas(ref_mat, x, ref_sched))
    y = spmv(to_port("bcsr", ref_mat), x, sched)
    assert y.dtype == torch.float32 and y.shape == (dense.shape[0],)
    tol = tol_for(sched.accum_dtype)
    assert_scaled_close(y.numpy(), dense.astype(np.float64) @ x, tol)
    assert_scaled_close(y.numpy(), y_ref, tol)
    # the port's own prepare + compile_spmv give the same answer
    y2 = compile_spmv(dense, "bcsr", sched, device="cpu")(x)
    assert_scaled_close(y2.numpy(), y_ref, tol)


@pytest.mark.parametrize("pattern", ["powerlaw", "denserows", "banded"])
def test_oracle_and_plain_version_against_dense(with_bcsr, pattern):
    from repro_torch.sparse.bcsr import spmv_bcsr

    dense = _dense(pattern, n=180)
    x = np.random.default_rng(2).normal(size=180).astype(np.float32)
    mat = prepare(dense, "bcsr", KernelSchedule(nnz_tile=512), device="cpu")
    assert mat.data.shape[0] % 4 == 0 and mat.data.shape[0] >= mat.n_blocks
    truth = dense.astype(np.float64) @ x
    assert_scaled_close(spmv_bcsr(mat, x).numpy(), truth, 1e-4)
    assert_scaled_close(spmv(mat, x, KernelSchedule(nnz_tile=512)).numpy(), truth, 1e-4)


def test_misaligned_storage_raises_in_both(with_bcsr):
    """Storage prepared for one block quantum and run under a schedule with
    another must raise InfeasibleConfig, never compute on the wrong layout."""
    dense = np.zeros((16, 256), np.float32)  # three occupied 8 x 128 blocks
    dense[0, 0] = dense[3, 200] = dense[9, 5] = 1.0
    mat = prepare(dense, "bcsr", KernelSchedule(rows_per_block=8), device="cpu")
    assert mat.data.shape[0] == 3
    x = np.ones(256, np.float32)
    with pytest.raises(InfeasibleConfig):
        spmv(mat, x, KernelSchedule(rows_per_block=8, nnz_tile=512))
    ref_mat = ref_prepare(dense, "bcsr", RefSchedule(rows_per_block=8))
    from repro.kernels.ops import InfeasibleConfig as RefInfeasible

    with pytest.raises(RefInfeasible):
        spmv_pallas(ref_mat, x, RefSchedule(rows_per_block=8, nnz_tile=512))


def test_storage_guard_refuses_in_both(with_bcsr, monkeypatch):
    from repro.kernels.ops import InfeasibleConfig as RefInfeasible
    from repro.sparse import registry as ref_reg
    from repro_torch.sparse import registry as port_reg

    dense = _dense("fem", n=128)
    monkeypatch.setattr(ref_reg, "MAX_STORAGE_BYTES", 1 << 16)
    monkeypatch.setattr(port_reg, "MAX_STORAGE_BYTES", 1 << 16)
    with pytest.raises(RefInfeasible, match="BCSR"):
        ref_prepare(dense, "bcsr", RefSchedule())
    with pytest.raises(InfeasibleConfig, match="BCSR"):
        prepare(dense, "bcsr", KernelSchedule(), device="cpu")


@pytest.mark.parametrize("kw", SCHEDULE_KW + [dict(x_residency="stream"),
                                              dict(rows_per_block=512, nnz_tile=1024)])
@pytest.mark.parametrize("pattern", ["fem", "powerlaw", "block"])
def test_footprint_identical(with_bcsr, pattern, kw):
    """Same work, traffic and working set as the reference's model; the
    feasibility bound is the card's L2 (FAST_MEMORY_BYTES), which no
    matrix of this size reaches in either package."""
    from repro.core.objectives import MatrixStats as RefStats
    from repro.sparse.bcsr import _bcsr_footprint as ref_footprint
    from repro_torch.core.objectives import MatrixStats
    from repro_torch.sparse.bcsr import _bcsr_footprint

    dense = _dense(pattern, n=220, avg=10.0, seed=5)
    a = _bcsr_footprint(MatrixStats(dense), KernelSchedule(**kw))
    b = ref_footprint(RefStats(dense), RefSchedule(**kw))
    assert dataclasses.astuple(a) == pytest.approx(dataclasses.astuple(b), rel=1e-12)
    assert a.feasible and a.useful_flops == 2 * int((dense != 0).sum())


def test_plain_version_on_cpu_counts_no_launch_and_checks_operands(with_bcsr):
    from repro_torch.sparse.bcsr import bcsr_from_dense

    dense = _dense("banded", n=96)
    mat = bcsr_from_dense(dense, br=16, pad_blocks_to=4, device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).normal(size=96).astype(np.float32))
    panels = torch.zeros(128)
    panels[:96] = x
    args = (mat.data, mat.block_cols, mat.block_rows, mat.block_ptr, panels.reshape(1, 128))
    s = KernelSchedule(rows_per_block=16)
    before = bcsr_spmv.launches
    y = bcsr_spmv(*args, s)
    assert torch.equal(y, bcsr_spmv_plain(*args, s)) and y.shape == (mat.n_block_rows, 16)
    assert bcsr_spmv.launches == before
    assert_scaled_close(y.reshape(-1)[:96].numpy(), dense.astype(np.float64) @ x.numpy(), 1e-4)
    with pytest.raises(ValueError):  # block_rows of the wrong length
        bcsr_spmv(mat.data, mat.block_cols, mat.block_rows[:-1].contiguous(),
                  mat.block_ptr, panels.reshape(1, 128), s)
    with pytest.raises(TypeError):  # int64 block columns
        bcsr_spmv(mat.data, mat.block_cols.long(), mat.block_rows, mat.block_ptr,
                  panels.reshape(1, 128), s)


def test_registration_is_idempotent_and_shared(with_bcsr):
    from repro.core.tuning_space import full_space as ref_space
    from repro.sparse import registry as ref_reg
    from repro_torch.core.tuning_space import full_space
    from repro_torch.sparse import bcsr
    from repro_torch.sparse import registry as port_reg

    assert bcsr.register() is bcsr.BCSR_SPEC and bcsr.register() is bcsr.BCSR_SPEC
    assert port_reg.format_names() == ref_reg.format_names()
    assert port_reg.format_names()[-1] == "bcsr" and bcsr.BCSR_SPEC.priority == 40
    assert [c.as_dict() for c in full_space()] == [c.as_dict() for c in ref_space()]
    assert port_reg.spec_for(prepare(np.eye(8, dtype=np.float32), "bcsr", device="cpu")).name == "bcsr"


def test_fixture_leaves_four_formats_behind():
    from repro.sparse import registry as ref_reg
    from repro_torch.sparse import registry as port_reg

    assert port_reg.format_names() == ref_reg.format_names() == ("csr", "ell", "bell", "sell")


def test_block_height_clamps_at_256_in_both(with_bcsr):
    """rows_per_block 256 and 512 share one storage (br is clamped at 256),
    in the port as in the reference."""
    from repro.sparse.bcsr import _bcsr_prepare as ref_bcsr_prepare
    from repro_torch.sparse.bcsr import _bcsr_prepare

    dense = _dense("fem", n=600, avg=5.0, seed=8)
    mats = [_bcsr_prepare(dense, KernelSchedule(rows_per_block=r), device="cpu") for r in (256, 512)]
    assert mats[0].br == mats[1].br == 256
    assert_same_storage("bcsr", ref_bcsr_prepare(dense, RefSchedule(rows_per_block=512)), mats[1])
    for n in ("data", "block_cols", "block_rows", "block_ptr"):
        assert torch.equal(getattr(mats[0], n), getattr(mats[1], n))
