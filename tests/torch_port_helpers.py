"""Helpers shared by the ``test_torch_*`` parity tests: carry the reference
package's containers across as numpy, and the scaled-error rule of
``test_kernels._check``."""

import dataclasses

import numpy as np

# the six schedules of tests/test_kernels.py, as keyword dicts so each
# package builds its own KernelSchedule from them
SCHEDULE_KW = [
    {},
    dict(rows_per_block=8, nnz_tile=128, unroll=1),
    dict(rows_per_block=32, nnz_tile=256, unroll=2),
    dict(rows_per_block=128, nnz_tile=512, unroll=4),
    dict(rows_per_block=16, nnz_tile=128, unroll=1, accum_dtype="bfloat16"),
    dict(rows_per_block=64, nnz_tile=128, dimension_semantics="parallel"),
]

PATTERNS = ["fem", "powerlaw", "block", "banded", "denserows"]
FORMATS = ["csr", "ell", "bell", "sell"]

ARRAY_FIELDS = {
    "csr": ("data", "indices", "indptr", "row_ids"),
    "ell": ("data", "cols"),
    "bell": ("data", "block_cols"),
    "sell": ("data", "cols", "slice_ptr", "slice_width", "row_ids"),
}
STATIC_FIELDS = {
    "csr": ("shape",),
    "ell": ("shape",),
    "bell": ("shape", "br", "bc"),
    "sell": ("shape", "C"),
}


def ref_arrays(fmt, mat):
    """A reference (JAX) container as ``(arrays, static)`` of numpy/python."""
    arrays = {n: np.asarray(getattr(mat, n)) for n in ARRAY_FIELDS[fmt]}
    static = {n: getattr(mat, n) for n in STATIC_FIELDS[fmt]}
    return arrays, static


def to_port(fmt, mat):
    """The port's container over the reference container's storage (CPU)."""
    from repro_torch.sparse.formats import container_from_numpy

    arrays, static = ref_arrays(fmt, mat)
    return container_from_numpy(fmt, arrays, device="cpu", **static)


def assert_same_storage(fmt, ref_mat, port_mat):
    """Array by array, dtype and values exact; static fields equal."""
    for n in ARRAY_FIELDS[fmt]:
        a = np.asarray(getattr(ref_mat, n))
        b = getattr(port_mat, n).numpy()
        assert a.dtype == b.dtype, (fmt, n, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{fmt}.{n}")
    for n in STATIC_FIELDS[fmt]:
        assert tuple(np.atleast_1d(getattr(ref_mat, n))) == tuple(
            np.atleast_1d(getattr(port_mat, n))
        ), (fmt, n)


def tol_for(accum_dtype: str) -> float:
    return 3e-2 if accum_dtype == "bfloat16" else 1e-4


def assert_scaled_close(y, ref, tol):
    """The ``_check`` rule of tests/test_kernels.py: compare after scaling by
    max |ref| (summation order differs between the implementations)."""
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(y / scale, ref / scale, atol=tol, rtol=tol)


def schedule_dict(s) -> dict:
    return dataclasses.asdict(s)
