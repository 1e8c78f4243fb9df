"""The reference and the frozen rules that make the benchmark's inputs."""

import numpy as np
import pytest
import torch

from bench.reference.generate import dense_from_coo, gaussian, symmetric_denserows_coo
from bench.reference.products import CsrReference, dense_product, gated_ffn, max_rel_err
from bench.reference.prune import magnitude_prune


def _draw(n, nnz, seed):
    gen = torch.Generator("cpu").manual_seed(seed)
    keys, vals = symmetric_denserows_coo(n, nnz, gen, "cpu")
    return keys.numpy(), vals.numpy()


@pytest.mark.parametrize("n,nnz,seed", [(50, 400, 1), (300, 300 * 40, 2), (17, 17 * 5, 3)])
def test_csr_reference_is_the_dense_float64_product(n, nnz, seed):
    keys, vals = _draw(n, nnz, seed)
    dense = dense_from_coo(n, n, keys, vals).astype(np.float64)
    x = np.random.default_rng(seed).normal(size=n)
    np.testing.assert_allclose(CsrReference(n, n, keys, vals) @ x, dense @ x, rtol=1e-12, atol=1e-12)


def test_csr_reference_keeps_empty_rows_zero_and_refuses_unsorted_positions():
    keys = np.array([0 * 4 + 1, 2 * 4 + 3])  # rows 1 and 3 empty
    ref = CsrReference(4, 4, keys, np.array([2.0, 5.0]))
    np.testing.assert_array_equal(ref @ np.arange(4.0), [2.0, 0.0, 15.0, 0.0])
    with pytest.raises(ValueError):
        CsrReference(4, 4, keys[::-1], np.array([2.0, 5.0]))


def test_the_matrix_is_symmetric_with_the_configurations_rows_and_nonzeros():
    n, nnz = 1434, 1434 * 126  # human_gene2's ~1,260 a row, ten times fewer of both
    keys, vals = _draw(n, nnz, 7)
    rows, cols = keys // n, keys % n
    counts = np.bincount(rows, minlength=n)
    assert keys.size == nnz and np.all(np.diff(keys) > 0)  # exact, sorted, distinct
    assert np.array_equal(keys[rows == cols], np.arange(n) * (n + 1))  # the full diagonal
    mirror = np.argsort(cols * n + rows)
    np.testing.assert_array_equal((cols * n + rows)[mirror], keys)
    np.testing.assert_array_equal(vals[mirror], vals)  # A == A.T, values too
    assert counts.mean() == nnz / n and 0.1 < counts.std() / counts.mean() < 0.25
    assert vals.min() >= 0.1 and vals.max() < 1.0 and vals.dtype == np.float32


@pytest.mark.parametrize("n,nnz", [(10, 9), (10, 15), (10, 101)])
def test_a_count_no_symmetric_matrix_has_is_refused(n, nnz):
    with pytest.raises(ValueError):
        _draw(n, nnz, 1)


def test_the_same_seed_draws_the_same_inputs():
    a, b, c = _draw(200, 4000, 11), _draw(200, 4000, 11), _draw(200, 4000, 12)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].shape != c[0].shape or np.any(a[0] != c[0])
    g1 = gaussian([(3, 4), (5,)], 0.5, torch.Generator().manual_seed(2**40 + 3), "cpu")
    g2 = gaussian([(3, 4), (5,)], 0.5, torch.Generator().manual_seed(2**40 + 3), "cpu")
    assert [t.shape for t in g1] == [(3, 4), (5,)]
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.parametrize("shape,density", [((64, 96), 0.5), ((96, 64), 0.5), ((7, 9), 0.3),
                                           ((10,), 0.0), ((10,), 1.0)])
def test_pruning_keeps_exactly_round_density_times_size(shape, density):
    w = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    out = magnitude_prune(w, density)
    k = int(round(density * w.size))
    assert np.count_nonzero(out) == k
    kept = np.abs(w[out != 0])
    if 0 < k < w.size:
        assert kept.min() >= np.abs(w[out == 0]).max()


def test_pruning_breaks_ties_by_the_earliest_index_as_the_port_does():
    from repro_torch.optim.compress import magnitude_prune as port_prune

    w = np.array([[1.0, -2.0, 2.0, 0.5], [-2.0, 3.0, 1.0, 2.0]], dtype=np.float32)
    out = magnitude_prune(w, 0.5)
    np.testing.assert_array_equal(out, [[0, -2.0, 2.0, 0], [-2.0, 3.0, 0, 0]])
    big = np.random.default_rng(9).normal(size=(300, 200)).astype(np.float32).round(1)
    np.testing.assert_array_equal(magnitude_prune(big, 0.5), port_prune(big, 0.5)[0])


def test_dense_product_and_the_gap_measure():
    x = np.arange(6.0).reshape(2, 3)
    w = np.ones((3, 2))
    np.testing.assert_array_equal(dense_product(x, w), [[3, 3], [12, 12]])
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (rng.normal(size=s) for s in ((3, 5), (5, 7), (5, 7), (7, 4)))
    g = torch.from_numpy(x @ wg)
    want = (torch.nn.functional.silu(g) * torch.from_numpy(x @ wu)).numpy() @ wd
    np.testing.assert_allclose(gated_ffn(x, wg, wu, wd), want, rtol=1e-12)
    ref = np.array([[1.0, -4.0], [2.0, 0.0]])
    assert max_rel_err(ref, ref) == 0.0
    assert max_rel_err(ref + [[0.0, 0.4], [0.0, 0.0]], ref) == pytest.approx(0.1)
    assert max_rel_err(ref[:1], ref) == float("inf")
    assert max_rel_err(np.full_like(ref, np.nan), ref) == float("inf")
