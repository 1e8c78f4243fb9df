"""ELL SpMM (kernel B8's path) in the port against the reference.

The reference runs ``repro.kernels.spmm_pallas`` in interpret mode and its
plain ``repro.sparse.spmm_ell``; the port runs ``ops.spmm`` with
``device="cpu"``, where ``ell_spmm`` takes its plain PyTorch version. Both
multiply the same ELL storage (the port's ``prepare`` builds it bit for bit).
Tolerances after scaling by max |ref|: 1e-5 for float32 accumulation (only
the summation order differs), 3e-2 for bfloat16 (rounding points differ)."""

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels import spmm_pallas
from repro.kernels.ref import spmm_dense as ref_spmm_dense
from repro.sparse import spmm_ell as ref_spmm_ell
from repro.sparse.generate import random_matrix
from repro_torch.kernels import KernelSchedule, prepare, spmm, spmv
from repro_torch.kernels.ell import ell_spmm, ell_spmm_plain
from repro_torch.kernels.ref import spmm_dense
from repro_torch.sparse import spmm_ell

from torch_port_helpers import assert_same_storage, assert_scaled_close

F32 = dict(rows_per_block=16, nnz_tile=128)
BF16 = dict(rows_per_block=16, nnz_tile=128, accum_dtype="bfloat16")


def _case(n=120, avg=7.0, pattern="powerlaw", k=3, seed=11):
    dense = random_matrix(n, avg, pattern, seed=seed).astype(np.float32)
    X = np.random.default_rng(seed + 1).normal(size=(dense.shape[1], k)).astype(np.float32)
    return dense, X


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("kw,tol", [(F32, 1e-5), (BF16, 3e-2)], ids=["f32", "bf16"])
def test_spmm_matches_reference_kernel_and_oracle(k, kw, tol):
    dense, X = _case(k=k)
    ref_mat = ref_prepare(dense, "ell", RefSchedule(**kw))
    mat = prepare(dense, "ell", KernelSchedule(**kw), device="cpu")
    assert_same_storage("ell", ref_mat, mat)
    Y_ref = np.asarray(spmm_pallas(ref_mat, X, RefSchedule(**kw)))
    Y = spmm(mat, X, KernelSchedule(**kw))
    assert isinstance(Y, torch.Tensor) and Y.dtype == torch.float32
    assert Y.shape == (dense.shape[0], k) == Y_ref.shape
    assert_scaled_close(Y.numpy(), Y_ref, tol)
    # the plain oracles of both packages, padded rows included
    oracle = np.asarray(ref_spmm_ell(ref_mat, X))
    assert_scaled_close(spmm_ell(mat, X).numpy(), oracle, 1e-5)
    assert_scaled_close(Y.numpy(), dense.astype(np.float64) @ X.astype(np.float64), tol)


@pytest.mark.parametrize("kw", [F32, BF16], ids=["f32", "bf16"])
def test_k1_equals_spmv_on_the_same_ell(kw):
    dense, X = _case(k=1, pattern="fem", seed=4)
    sched = KernelSchedule(**kw)
    mat = prepare(dense, "ell", sched, device="cpu")
    y = spmv(mat, X[:, 0], sched)
    Y = spmm(mat, X, sched)
    np.testing.assert_allclose(Y[:, 0].numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


def test_layout_when_rows_equal_columns_of_x():
    """R == k: a transposed Y would have the right shape and wrong values."""
    n = 32
    dense = random_matrix(n, 5.0, "fem", seed=2).astype(np.float32)
    dense[0, :] = 0.0
    dense[0, 3] = 2.0  # row 0 picks X[3, :] only
    X = np.arange(n * n, dtype=np.float32).reshape(n, n)
    sched = KernelSchedule(rows_per_block=8, nnz_tile=128)
    Y = spmm(prepare(dense, "ell", sched, device="cpu"), X, sched).numpy()
    np.testing.assert_allclose(Y[0], 2.0 * X[3], rtol=1e-6)
    assert_scaled_close(Y, dense.astype(np.float64) @ X, 1e-5)
    assert not np.allclose(Y, (dense.astype(np.float64) @ X).T)


def test_spmm_refuses_other_containers_and_misaligned_planes():
    dense, X = _case()
    with pytest.raises(TypeError, match="ELL"):
        spmm(prepare(dense, "csr", device="cpu"), X)
    sched = KernelSchedule(**F32)
    mat = prepare(dense, "ell", sched, device="cpu")
    with pytest.raises(ValueError, match="not aligned"):
        ell_spmm(mat.data[:-1].contiguous(), mat.cols[:-1].contiguous(),
                 torch.as_tensor(X), sched)
    with pytest.raises(ValueError, match="not aligned"):
        spmm(mat, X, KernelSchedule(rows_per_block=16, nnz_tile=256))
    with pytest.raises(TypeError, match="float32"):
        ell_spmm(mat.data, mat.cols, torch.as_tensor(X, dtype=torch.float64), sched)
    with pytest.raises(TypeError, match="int32"):
        ell_spmm(mat.data, mat.cols.long(), torch.as_tensor(X), sched)
    with pytest.raises(ValueError, match="2 dim"):
        ell_spmm(mat.data, mat.cols, torch.as_tensor(X[:, 0]), sched)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmm(mat.data, mat.cols, torch.as_tensor(X).t().contiguous().t(), sched)
    with pytest.raises(RuntimeError, match="no kernel"):
        ell_spmm(mat.data.to("meta"), mat.cols.to("meta"),
                 torch.empty(X.shape, device="meta"), sched)


def test_plain_version_and_launch_counter():
    dense, X = _case(k=5)
    sched = KernelSchedule(**BF16)
    mat = prepare(dense, "ell", sched, device="cpu")
    before = ell_spmm.launches
    Y = ell_spmm(mat.data, mat.cols, torch.as_tensor(X), sched)
    assert ell_spmm.launches == before  # the CPU takes the plain version
    assert torch.equal(Y, ell_spmm_plain(mat.data, mat.cols, torch.as_tensor(X), sched))
    # bf16: products rounded to bf16, so not bit-equal to the float32 sum
    f32 = ell_spmm_plain(mat.data, mat.cols, torch.as_tensor(X), KernelSchedule(**F32))
    assert_scaled_close(Y.numpy(), f32.numpy(), 3e-2)


def test_spmm_dense_matches_reference():
    dense, X = _case(k=4)
    got = spmm_dense(dense, X, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (dense.shape[0], 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_spmm_dense(dense, X)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="CUDA"):
        spmm_dense(dense, X)  # device=None is the card
