"""Port vs reference: the seeded generator, the four host converters, their
inverses and the numpy hand-over of containers. Everything here is exact
(bit-for-bit): both packages run the same numpy code on the same input."""

import numpy as np
import pytest
import torch

from repro.sparse import formats as ref_formats
from repro.sparse import generate as ref_generate
from repro.sparse.spmv import spmv as ref_spmv
from repro_torch.sparse import formats as port_formats
from repro_torch.sparse import generate as port_generate
from repro_torch.sparse.spmv import spmv as port_spmv
from repro_torch.sparse.formats import container_from_numpy, container_to_numpy

from torch_port_helpers import (
    ARRAY_FIELDS,
    FORMATS,
    PATTERNS,
    assert_same_storage,
    ref_arrays,
    to_port,
)

GEN_PATTERNS = [p for p in ref_generate.PATTERN_NAMES if p != "prunedffn"]


@pytest.mark.parametrize("pattern", GEN_PATTERNS)
def test_random_matrix_bitwise(pattern):
    a = ref_generate.random_matrix(150, 7.0, pattern, seed=3)
    b = port_generate.random_matrix(150, 7.0, pattern, seed=3)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["rim", "human_gene2", "pkustk04", "amazon0601"])
def test_suite_matrix_bitwise(name):
    assert port_generate.MATRIX_NAMES == ref_generate.MATRIX_NAMES
    a = ref_generate.generate_by_name(name, scale=0.004)
    b = port_generate.generate_by_name(name, scale=0.004)
    assert a.tobytes() == b.tobytes()


def test_prunedffn_waits_for_its_slice():
    """The pruned-FFN pattern needs optim.compress, which is not ported yet:
    it must fail loudly, and it is not one of the paper's 30 names."""
    assert "pruned-ffn" not in port_generate.MATRIX_NAMES
    with pytest.raises(ModuleNotFoundError):
        port_generate.random_matrix(64, 4.0, "prunedffn", seed=0)


def _dense(pattern, n=140, avg=6.0, seed=9):
    return ref_generate.random_matrix(n, avg, pattern, seed=seed).astype(np.float32)


_KW = {
    "csr": {},
    "ell": {"min_width": 16},
    "bell": {"br": 16, "bc": 128},
    "sell": {"C": 16, "q": 128},
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_converter_matches_reference(fmt, pattern):
    dense = _dense(pattern)
    ref_mat = getattr(ref_formats, f"{fmt}_from_dense")(dense, **_KW[fmt])
    port_mat = getattr(port_formats, f"{fmt}_from_dense")(dense, device="cpu", **_KW[fmt])
    assert_same_storage(fmt, ref_mat, port_mat)
    assert ref_mat.nbytes == port_mat.nbytes
    assert ref_mat.nbytes_core == port_mat.nbytes_core
    for n in ARRAY_FIELDS[fmt]:
        assert getattr(port_mat, n).device.type == "cpu"


@pytest.mark.parametrize("fmt", FORMATS)
def test_round_trip_exact(fmt):
    dense = _dense("powerlaw", n=97)
    mat = port_formats.from_dense(dense, fmt, device="cpu")
    back = port_formats.to_dense(mat)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, dense)
    # and the reference's inverse agrees on the same storage
    ref_mat = ref_formats.from_dense(dense, fmt)
    np.testing.assert_array_equal(ref_formats.to_dense(ref_mat), back)


@pytest.mark.parametrize("fmt", FORMATS)
def test_container_from_numpy_shares_storage(fmt):
    dense = _dense("fem", n=120)
    ref_mat = ref_formats.from_dense(dense, fmt)
    port_mat = to_port(fmt, ref_mat)
    assert_same_storage(fmt, ref_mat, port_mat)
    x = np.random.default_rng(0).normal(size=dense.shape[1]).astype(np.float32)
    y_ref = np.asarray(ref_spmv(ref_mat, x))
    y_port = port_spmv(port_mat, x).numpy()
    np.testing.assert_allclose(y_port, y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_port, dense @ x, rtol=1e-4, atol=1e-4)
    # and back out again, array for array
    fmt2, arrays, static = container_to_numpy(port_mat)
    ref_a, ref_s = ref_arrays(fmt, ref_mat)
    assert fmt2 == fmt and static == ref_s
    for n, a in ref_a.items():
        np.testing.assert_array_equal(arrays[n], a)


def test_container_from_numpy_rejects_bad_input():
    with pytest.raises(ValueError):
        container_from_numpy("coo", {}, device="cpu", shape=(2, 2))
    with pytest.raises(ValueError):
        container_from_numpy("ell", {"data": np.zeros((2, 2))}, device="cpu", shape=(2, 2))
    with pytest.raises(ValueError):
        container_from_numpy(
            "bell", {"data": np.zeros((1, 1, 8, 128)), "block_cols": np.zeros((1, 1))},
            device="cpu", shape=(8, 128),
        )  # br / bc missing


@pytest.mark.parametrize("fmt,field", [("csr", "indices"), ("csr", "indptr"), ("ell", "cols"),
                                       ("bell", "block_cols"), ("sell", "cols"),
                                       ("sell", "slice_ptr")])
def test_container_from_numpy_rejects_out_of_bounds_indices(fmt, field):
    """Indices that would send a kernel's gather out of bounds are refused
    on the host, before any pointer reaches the card."""
    arrays, static = ref_arrays(fmt, ref_formats.from_dense(_dense("fem", n=64), fmt))
    container_from_numpy(fmt, arrays, device="cpu", **static)  # intact: accepted
    bad = {k: v.copy() for k, v in arrays.items()}
    bad[field].reshape(-1)[-1] = 10_000
    with pytest.raises(ValueError):
        container_from_numpy(fmt, bad, device="cpu", **static)


@pytest.mark.parametrize("src,dst", [("csr", "sell"), ("ell", "bell"), ("sell", "csr")])
def test_convert_between_formats(src, dst):
    dense = _dense("banded", n=80)
    a = port_formats.from_dense(dense, src, device="cpu")
    b = port_formats.convert(a, dst)
    assert type(b).__name__ == dst.upper()
    assert b.data.device == a.data.device
    np.testing.assert_array_equal(port_formats.to_dense(b), dense)


def test_containers_are_frozen_tensor_dataclasses():
    mat = port_formats.csr_from_dense(_dense("fem", n=40), device="cpu")
    assert isinstance(mat.data, torch.Tensor) and mat.data.dtype == torch.float32
    assert mat.indices.dtype == torch.int32 and mat.indptr.dtype == torch.int32
    with pytest.raises(Exception):
        mat.shape = (1, 1)
