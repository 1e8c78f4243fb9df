"""Port vs reference, kernel by kernel, on the same prepared storage.

The reference runs its Pallas kernels in interpret mode on the CPU
(``repro.kernels.ops.spmv_pallas``); the port runs with ``device="cpu"``,
where each wrapper takes its kernel's plain PyTorch version. Tolerances are
the reference tests' own (``tests/test_kernels.py``): after scaling by
max |ref|, 1e-4 for float32 accumulation and 3e-2 for bfloat16 (summation
order and bf16 rounding points differ between the implementations)."""

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels import spmv_pallas
from repro.sparse.generate import random_matrix
from repro_torch.kernels import (
    DEFAULT_SCHEDULE,
    InfeasibleConfig,
    KernelSchedule,
    compile_spmv,
    prepare,
    spmv,
)
from repro_torch.kernels.bell import bell_spmv, bell_spmv_plain
from repro_torch.kernels.csr import csr_spmv, csr_spmv_plain
from repro_torch.kernels.ell import ell_spmv, ell_spmv_plain
from repro_torch.kernels.ref import spmv_dense
from repro_torch.kernels.sell import sell_spmv, sell_spmv_plain
from repro_torch.sparse.spmv import spmv as oracle

from torch_port_helpers import (
    FORMATS,
    PATTERNS,
    SCHEDULE_KW,
    assert_same_storage,
    assert_scaled_close,
    to_port,
    tol_for,
)


def _parity(dense, fmt, kw):
    """Reference kernel and port on the reference's prepared storage, both
    against the dense product and against each other."""
    ref_sched, sched = RefSchedule(**kw), KernelSchedule(**kw)
    x = np.random.default_rng(0).normal(size=dense.shape[1]).astype(np.float32)
    ref_mat = ref_prepare(dense, fmt, ref_sched)
    y_ref = np.asarray(spmv_pallas(ref_mat, x, ref_sched))
    # the port's own prepare yields the very same storage ...
    port_mat = prepare(dense, fmt, sched, device="cpu")
    assert_same_storage(fmt, ref_mat, port_mat)
    # ... and multiplying the reference's arrays gives the reference's answer
    y = spmv(to_port(fmt, ref_mat), x, sched)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert y.shape == (dense.shape[0],)
    tol = tol_for(sched.accum_dtype)
    truth = dense.astype(np.float64) @ x
    assert_scaled_close(y.numpy(), truth, tol)
    assert_scaled_close(y.numpy(), y_ref, tol)
    assert_scaled_close(spmv_dense(dense, x, device="cpu").numpy(), truth, 1e-4)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sched_i", range(len(SCHEDULE_KW)))
def test_schedule_sweep(fmt, sched_i):
    dense = random_matrix(250, 11.0, "fem", seed=42).astype(np.float32)
    _parity(dense, fmt, SCHEDULE_KW[sched_i])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_pattern_sweep(fmt, pattern):
    dense = random_matrix(200, 8.0, pattern, seed=9).astype(np.float32)
    _parity(dense, fmt, {})


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,avg,seed", [(8, 1.0, 1), (65, 3.5, 7), (300, 24.0, 11)])
def test_shapes(fmt, n, avg, seed):
    dense = random_matrix(n, avg, "fem", seed=seed).astype(np.float32)
    _parity(dense, fmt, dict(rows_per_block=8, nnz_tile=128))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_empty_rows(fmt, accum):
    """Rows with zero nonzeros must produce exact zeros."""
    dense = np.zeros((64, 64), dtype=np.float32)
    dense[10, 3] = 2.0
    dense[50, 60] = -1.5
    x = np.ones(64, dtype=np.float32)
    sched = KernelSchedule(accum_dtype=accum)
    y = spmv(prepare(dense, fmt, sched, device="cpu"), x, sched).numpy()
    np.testing.assert_allclose(y, dense @ x, atol=1e-6)
    assert (y[np.setdiff1d(np.arange(64), [10, 50])] == 0.0).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_version_matches_oracle(fmt):
    """Wrapper on CPU == plain version == the format's oracle."""
    dense = random_matrix(130, 9.0, "powerlaw", seed=4).astype(np.float32)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=130).astype(np.float32))
    mat = prepare(dense, fmt, DEFAULT_SCHEDULE, device="cpu")
    y = spmv(mat, x, DEFAULT_SCHEDULE)
    # ELL storage is row-padded to the schedule, so its oracle returns R >= n rows
    np.testing.assert_allclose(
        y.numpy(), oracle(mat, x).numpy()[: dense.shape[0]], rtol=1e-5, atol=1e-5
    )


def test_misaligned_schedule_rejected():
    dense = random_matrix(100, 6.0, "fem", seed=5).astype(np.float32)
    mat = prepare(dense, "ell", KernelSchedule(nnz_tile=128), device="cpu")
    with pytest.raises(InfeasibleConfig):
        spmv(mat, np.ones(dense.shape[1], np.float32), KernelSchedule(nnz_tile=512))
    # the reference raises at the same place
    from repro.kernels import InfeasibleConfig as RefInfeasible

    ref_mat = ref_prepare(dense, "ell", RefSchedule(nnz_tile=128))
    with pytest.raises(RefInfeasible):
        spmv_pallas(ref_mat, np.ones(dense.shape[1], np.float32), RefSchedule(nnz_tile=512))


def test_sell_nnz_tile_mismatch_rejected():
    dense = random_matrix(100, 6.0, "fem", seed=5).astype(np.float32)
    mat = prepare(dense, "sell", KernelSchedule(nnz_tile=128), device="cpu")
    x = np.ones(dense.shape[1], np.float32)
    with pytest.raises(InfeasibleConfig):
        spmv(mat, x, KernelSchedule(nnz_tile=256))
    with pytest.raises(InfeasibleConfig):  # the verdict is remembered, not flipped
        spmv(mat, x, KernelSchedule(nnz_tile=256))
    assert spmv(mat, x, KernelSchedule(nnz_tile=128)).shape == (100,)


def test_compile_spmv_end_to_end():
    dense = random_matrix(128, 9.0, "block", seed=8).astype(np.float32)
    x = np.random.default_rng(3).normal(size=dense.shape[1]).astype(np.float32)
    fn = compile_spmv(dense, "bell", KernelSchedule(rows_per_block=16), device="cpu")
    assert fn.device == torch.device("cpu") and fn.mat.br == 16 and fn.mat.bc == 128
    np.testing.assert_allclose(fn(x).numpy(), dense @ x, rtol=1e-4, atol=1e-4)


def test_schedule_validation_and_fields_match_reference():
    for bad in (dict(rows_per_block=10), dict(nnz_tile=100), dict(unroll=3),
                dict(accum_dtype="float16"), dict(x_residency="hbm")):
        with pytest.raises(ValueError):
            KernelSchedule(**bad)
        with pytest.raises(ValueError):
            RefSchedule(**bad)
    assert KernelSchedule().as_dict() == RefSchedule().as_dict()
    assert KernelSchedule(accum_dtype="bfloat16").torch_accum_dtype == torch.bfloat16
    assert DEFAULT_SCHEDULE.torch_accum_dtype == torch.float32
    from repro.kernels import common as ref_common
    from repro_torch.kernels import common as port_common

    for name in ("ROWS_PER_BLOCK_CHOICES", "NNZ_TILE_CHOICES", "UNROLL_CHOICES",
                 "ACCUM_DTYPE_CHOICES", "X_RESIDENCY_CHOICES", "LANE", "SUBLANE"):
        assert getattr(ref_common, name) == getattr(port_common, name)


def _csr_args(dense):
    mat = prepare(dense, "csr", DEFAULT_SCHEDULE, device="cpu")
    x = torch.ones(dense.shape[1], dtype=torch.float32)
    return mat, x


def test_wrappers_reject_what_the_kernels_do_not_take():
    dense = random_matrix(64, 5.0, "fem", seed=2).astype(np.float32)
    mat, x = _csr_args(dense)
    s = DEFAULT_SCHEDULE
    with pytest.raises(TypeError):  # float64 x
        csr_spmv(mat.data, mat.indices, mat.indptr, x.double(), s)
    with pytest.raises(TypeError):  # int64 indices
        csr_spmv(mat.data, mat.indices.long(), mat.indptr, x, s)
    with pytest.raises(ValueError):  # non-contiguous x
        csr_spmv(mat.data, mat.indices, mat.indptr, torch.ones(128)[::2], s)
    with pytest.raises(TypeError):  # numpy instead of a tensor
        csr_spmv(mat.data.numpy(), mat.indices, mat.indptr, x, s)
    ell = prepare(dense, "ell", s, device="cpu")
    with pytest.raises(ValueError):  # planes not aligned to the schedule
        ell_spmv(ell.data, ell.cols, x, KernelSchedule(nnz_tile=512))
    with pytest.raises(ValueError):  # rank
        ell_spmv(ell.data.reshape(-1), ell.cols.reshape(-1), x, s)
    sell = prepare(dense, "sell", s, device="cpu")
    with pytest.raises(ValueError):  # slice_ptr of the wrong length
        sell_spmv(sell.data, sell.cols, sell.slice_ptr[:-1].contiguous(),
                  sell.slice_width, x, sell.C, s)
    bell = prepare(dense, "bell", s, device="cpu")
    with pytest.raises(ValueError):  # panels of another width
        bell_spmv(bell.data, bell.block_cols, torch.ones(1, 64), s)


@pytest.mark.parametrize("fmt", FORMATS)
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(fmt):
    """On a CPU tensor the wrapper returns exactly its plain version and its
    launch counter (kernel launches only) does not move."""
    dense = random_matrix(96, 6.0, "banded", seed=6).astype(np.float32)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=96).astype(np.float32))
    s = KernelSchedule(rows_per_block=16, unroll=2)
    m = prepare(dense, fmt, s, device="cpu")
    if fmt == "csr":
        w, args, plain = csr_spmv, (m.data, m.indices, m.indptr, x, s), csr_spmv_plain
    elif fmt == "ell":
        w, args, plain = ell_spmv, (m.data, m.cols, x, s), ell_spmv_plain
    elif fmt == "sell":
        w, args, plain = (sell_spmv,
                          (m.data, m.cols, m.slice_ptr, m.slice_width, x, m.C, s),
                          sell_spmv_plain)
    else:
        panels = torch.zeros(128)
        panels[:96] = x
        w, args, plain = bell_spmv, (m.data, m.block_cols, panels.reshape(1, 128), s), bell_spmv_plain
    before = w.launches
    assert torch.equal(w(*args), plain(*args))
    assert w.launches == before
