"""The fused single-launch partitioned SpMV, port vs reference: host
lowering (``flatten_block``, ``lower_fused``), the port's own tile rule,
the kernel's plain version against the reference's Pallas kernel in
interpret mode on the same stream, both executors against the reference's
on forced plans, and the fused kernel memo.

Tolerances as in ``tests/test_kernels.py``: scaled by max |reference|,
1e-4 for float32 and 3e-2 for bfloat16 accumulation (the reference keeps an
ordered bf16 running sum; the port rounds products and sums in float32)."""

import numpy as np
import pytest
import torch

from repro.kernels import KernelSchedule as RefSchedule
from repro.kernels import prepare as ref_prepare
from repro.kernels.fused import flatten_block as ref_flatten
from repro.kernels.fused import fused_schedule_params as ref_params
from repro.kernels.fused import fused_spmv_pallas
from repro.kernels.fused import lower_fused as ref_lower
from repro.partition import compile_fused_partitioned as ref_compile_fused
from repro.partition import compile_partitioned as ref_compile_partitioned
from repro.sparse.generate import random_matrix
from repro_torch.kernels import KernelSchedule, prepare
from repro_torch.kernels.common import LANE, MAX_FUSED_STEPS, MIN_FUSED_TILE, fused_nnz_tile
from repro_torch.kernels.fused import (
    flatten_block,
    fused_schedule_params,
    fused_spmv,
    fused_spmv_plain,
    lower_fused,
)
from repro_torch.kernels.ops import (
    clear_kernel_memo,
    compile_spmv_fused,
    evict_kernel_memo_format,
    fused_plan_signature,
    kernel_memo_stats,
)
from repro_torch.partition import compile_fused_partitioned, compile_partitioned

from torch_port_helpers import (
    FORMATS,
    SCHEDULE_KW,
    assert_scaled_close,
    hetero_matrix,
    plan_pair,
    to_port,
    tol_for,
    with_bcsr,  # noqa: F401  (fixture)
)


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _assert_same_stream(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def _real(stream_d, stream_c, stream_r, n_rows):
    keep = np.asarray(stream_r) != n_rows
    return (np.asarray(stream_d)[keep], np.asarray(stream_c)[keep], np.asarray(stream_r)[keep])


# ------------------------------------------------------------- lowering


@pytest.mark.parametrize("fmt", FORMATS + ["bcsr"])
@pytest.mark.parametrize("pattern", ["powerlaw", "fem", "block"])
def test_flatten_block_identical(with_bcsr, fmt, pattern):
    """Same element order, same columns, same global rows, padding dropped
    — for the four seed formats and the BCSR plugin's ``to_dense`` route."""
    dense = random_matrix(200, 6.0, pattern, seed=7).astype(np.float32)
    block = dense[40:170]
    kw = dict(rows_per_block=16, nnz_tile=256)
    ref = ref_flatten(ref_prepare(block, fmt, RefSchedule(**kw)), 40)
    ours = flatten_block(prepare(block, fmt, KernelSchedule(**kw), device="cpu"), 40)
    _assert_same_stream(ours, ref)
    assert ours[0].size == int((block != 0).sum())
    assert ours[2].min() >= 40 and ours[2].max() < 170


@pytest.mark.parametrize("fmt", FORMATS)
def test_flatten_block_drops_an_explicitly_stored_zero(fmt):
    """A value stored as 0 (not a padding slot) is dropped by both packages'
    ``data != 0`` filter: the stream holds one entry fewer than the storage's
    nonzero pattern."""
    dense = random_matrix(96, 5.0, "banded", seed=2).astype(np.float32)
    ref_mat = ref_prepare(dense, fmt, RefSchedule())
    data = np.array(ref_mat.data)
    flat = data.reshape(-1)
    first = int(np.flatnonzero(flat)[0])
    flat[first] = 0.0  # an explicit zero where a nonzero was stored
    import dataclasses

    import jax.numpy as jnp

    ref_zeroed = dataclasses.replace(ref_mat, data=jnp.asarray(data))
    ref = ref_flatten(ref_zeroed, 0)
    ours = flatten_block(to_port(fmt, ref_zeroed), 0)
    _assert_same_stream(ours, ref)
    assert ours[0].size == int((dense != 0).sum()) - 1


@pytest.mark.parametrize("fmts,k", [(["csr"], 1), (["ell", "sell"], 2),
                                    (["csr", "ell", "bell", "sell"], 4), (["bell"], 8)])
def test_lower_fused_streams_identical_before_padding(fmts, k):
    dense = hetero_matrix(256)
    ref_plan, plan = plan_pair(dense, fmts, k)
    ref = ref_lower(dense, ref_plan)
    ours = lower_fused(dense, plan, device="cpu")
    n = dense.shape[0]
    _assert_same_stream(
        _real(ours.data.numpy(), ours.cols.numpy(), ours.rows.numpy(), n),
        _real(ref.data, ref.cols, ref.rows, n),
    )
    assert ours.formats == ref.formats and ours.n_rows == ref.n_rows
    assert (ours.unroll, ours.accum_dtype) == (ref.unroll, ref.accum_dtype)


@pytest.mark.parametrize("fmts,k", [(["csr"], 1), (["csr", "ell", "bell", "sell"], 4),
                                    (["sell"], 8)])
def test_lower_fused_work_descriptor_invariants(fmts, k):
    """The port's own tile rule: one tile per CTA, lane-aligned, every tile
    owned by one block and holding only that block's rows (or the spill)."""
    dense = hetero_matrix(512)
    _, plan = plan_pair(dense, fmts, k)
    f = lower_fused(dense, plan, device="cpu")
    total = int((dense != 0).sum())
    assert f.tile == fused_nnz_tile(total) and f.tile % LANE == 0
    assert f.data.shape[0] == f.n_tiles * f.tile == f.cols.shape[0] == f.rows.shape[0]
    assert f.tile_map.dtype == torch.int32 and f.rows.dtype == torch.int32
    np.testing.assert_array_equal(f.tile_map.numpy(), np.arange(f.n_tiles))
    assert len(f.block_of_tile) == f.n_tiles
    assert list(f.block_of_tile) == sorted(f.block_of_tile)
    rows = f.rows.numpy().reshape(f.n_tiles, f.tile)
    for t, b in enumerate(f.block_of_tile):
        blk = plan.blocks[b].block
        real = rows[t][rows[t] != f.n_rows]
        assert real.size and real.min() >= blk.row_start and real.max() < blk.row_end
    pad = f.rows.numpy() == f.n_rows
    assert (f.data.numpy()[pad] == 0).all() and (f.cols.numpy()[pad] == 0).all()


@pytest.mark.parametrize("total", [0, 1, 127, 2048, 100_000, 1_081_344, 8_813_632, 40_000_000])
def test_fused_tile_rule_for_the_card(total):
    tile = fused_nnz_tile(max(total, 1))
    n_tiles = -(-max(total, 1) // tile)
    assert tile % LANE == 0 and tile >= MIN_FUSED_TILE
    assert n_tiles <= MAX_FUSED_STEPS == 4 * 132
    if total >= MAX_FUSED_STEPS * MIN_FUSED_TILE:  # large: ~4 CTAs on each SM
        assert n_tiles >= 0.9 * MAX_FUSED_STEPS  # lane rounding costs a few
    else:  # small: fewer CTAs, each with the minimum work
        assert tile == MIN_FUSED_TILE


@pytest.mark.parametrize("kws,tile", [
    ([{}], 2048),
    ([dict(unroll=4), dict(unroll=2)], 2048),
    ([dict(unroll=8, accum_dtype="bfloat16"), dict(unroll=4, accum_dtype="bfloat16")], 2048),
    ([dict(unroll=8, accum_dtype="bfloat16"), dict(unroll=8)], 128),
    ([], 256),
    ([dict(unroll=8)], 132),
])
def test_fused_schedule_params_identical(kws, tile):
    ours = fused_schedule_params([KernelSchedule(**kw) for kw in kws], tile)
    assert ours == ref_params([RefSchedule(**kw) for kw in kws], tile)


# ------------------------------------------------------ kernel vs Pallas


def _stream_case(name):
    if name == "hetero":
        return hetero_matrix(256), ["csr", "ell", "bell", "sell"], 4
    if name == "zeros":
        return np.zeros((64, 64), np.float32), ["csr"], 2
    if name == "empty_block":
        dense = random_matrix(128, 5.0, "fem", seed=1).astype(np.float32)
        dense[32:96] = 0.0  # the middle blocks hold no nonzero
        return dense, ["ell", "csr"], 4
    if name == "hub_row":
        dense = random_matrix(160, 2.0, "banded", seed=3).astype(np.float32)
        dense[17, :] = np.linspace(-1.0, 1.0, 160, dtype=np.float32)
        return dense, ["sell", "csr"], 2
    raise ValueError(name)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["hetero", "zeros", "empty_block", "hub_row"])
def test_plain_version_matches_reference_kernel_on_the_same_stream(case, accum):
    """The reference lowers; its stream goes to the Pallas kernel (interpret
    mode) and, as numpy, to the port's wrapper on CPU tensors."""
    dense, fmts, k = _stream_case(case)
    ref_plan, _ = plan_pair(dense, fmts, k, dict(accum_dtype=accum, unroll=2))
    ref = ref_lower(dense, ref_plan)
    x = _x(dense.shape[1], seed=4)
    y_ref = np.asarray(fused_spmv_pallas(
        ref.data, ref.cols, ref.rows, ref.tile_map, x, ref.n_rows, ref.tile,
        unroll=ref.unroll, accum_dtype=ref.accum_dtype, interpret=True))
    args = [torch.from_numpy(np.array(a)) for a in (ref.data, ref.cols, ref.rows, ref.tile_map)]
    before = fused_spmv.launches
    y = fused_spmv(*args, torch.from_numpy(x), ref.n_rows, ref.tile,
                   unroll=ref.unroll, accum_dtype=ref.accum_dtype)
    assert fused_spmv.launches == before  # CPU tensors: the plain version, no launch
    assert y.shape == (ref.n_rows + 1,) and y.dtype == torch.float32
    assert torch.equal(y, fused_spmv_plain(*args, torch.from_numpy(x), ref.n_rows, ref.tile,
                                           unroll=ref.unroll, accum_dtype=ref.accum_dtype))
    tol = tol_for(ref.accum_dtype)
    assert_scaled_close(y.numpy()[:-1], y_ref[:-1], tol)
    assert_scaled_close(y.numpy()[:-1], dense.astype(np.float64) @ x, tol)


def test_plain_version_follows_the_work_descriptor():
    """Tiles are taken in ``tile_map`` order, and a map naming one tile twice
    (and another not at all) changes y: the descriptor is read, not assumed
    to be the identity."""
    dense = hetero_matrix(256)
    _, plan = plan_pair(dense, ["csr", "ell"], 2)
    f = lower_fused(dense, plan, device="cpu")
    x = torch.from_numpy(_x(256, seed=6))
    full = fused_spmv(f.data, f.cols, f.rows, f.tile_map, x, f.n_rows, f.tile)
    flipped = torch.flip(f.tile_map, [0]).contiguous()
    assert torch.allclose(full, fused_spmv(f.data, f.cols, f.rows, flipped, x, f.n_rows, f.tile),
                          atol=1e-5)
    assert f.n_tiles > 1
    dup = f.tile_map.clone()
    dup[-1] = dup[0]
    assert not torch.allclose(full, fused_spmv(f.data, f.cols, f.rows, dup, x, f.n_rows, f.tile))


def test_wrapper_checks_its_operands():
    d = torch.zeros(256)
    c = r = torch.zeros(256, dtype=torch.int32)
    tmap = torch.arange(2, dtype=torch.int32)
    x = torch.zeros(8)
    with pytest.raises(ValueError):  # stream length != n_tiles * tile
        fused_spmv(d, c, r, tmap, x, 8, 256)
    with pytest.raises(TypeError):  # int64 rows
        fused_spmv(d, c, r.long(), tmap, x, 8, 128)
    with pytest.raises(ValueError):  # rank
        fused_spmv(d.reshape(2, 128), c, r, tmap, x, 8, 128)
    assert fused_spmv(d, c, r, tmap, x, 8, 128).shape == (9,)


# ------------------------------------------------------------- executors


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_executors_match_reference_per_format(fmt, k):
    dense = random_matrix(160, 6.0, "powerlaw", seed=11).astype(np.float32)
    x = _x(160, seed=1)
    ref_plan, plan = plan_pair(dense, [fmt], k)
    y_ref = np.asarray(ref_compile_fused(dense, ref_plan)(x))
    fused = compile_fused_partitioned(dense, plan, device="cpu")
    seq = compile_partitioned(dense, plan, device="cpu")
    y_fused, y_seq = fused(x).numpy(), seq(x).numpy()
    truth = dense.astype(np.float64) @ x
    for y in (y_fused, y_seq):
        assert_scaled_close(y, truth, 1e-4)
        assert_scaled_close(y, y_ref, 1e-4)
    assert_scaled_close(y_fused, y_seq, 1e-4)
    assert fused.formats == seq.formats == (fmt,) * fused.n_blocks


@pytest.mark.parametrize("fmts", [["csr", "ell"], ["sell", "bell"], ["csr", "ell", "bell", "sell"]])
@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_executors_match_reference_heterogeneous(fmts, accum):
    dense = hetero_matrix(256)
    x = _x(256, seed=2)
    ref_plan, plan = plan_pair(dense, fmts, 4, dict(accum_dtype=accum))
    y_ref_fused = np.asarray(ref_compile_fused(dense, ref_plan)(x))
    y_ref_seq = np.asarray(ref_compile_partitioned(dense, ref_plan)(x))
    fused = compile_fused_partitioned(dense, plan, device="cpu")
    y_fused = fused(x).numpy()
    y_seq = compile_partitioned(dense, plan, device="cpu")(x).numpy()
    tol = tol_for(accum)
    for y, y_ref in ((y_fused, y_ref_fused), (y_seq, y_ref_seq)):
        assert_scaled_close(y, y_ref, tol)
        assert_scaled_close(y, dense.astype(np.float64) @ x, tol)
    assert_scaled_close(y_fused, y_seq, tol)
    assert fused.kernel.accum_dtype == accum and set(fused.formats) == set(fmts)
    d = fused.descriptor()
    assert d["tile"] == fused.kernel.tile and d["tile_map"] == list(range(fused.n_tiles))
    assert d["block_ranges"] == [(bp.block.row_start, bp.block.row_end) for bp in plan.blocks]
    assert len(d["block_of_tile"]) == fused.n_tiles


def test_bcsr_block_through_both_executors(with_bcsr):
    """A plugin block lowers through its registered ``to_dense``."""
    dense = hetero_matrix(256)
    x = _x(256, seed=3)
    ref_plan, plan = plan_pair(dense, ["bcsr", "csr", "ell", "sell"], 4)
    y_ref = np.asarray(ref_compile_fused(dense, ref_plan)(x))
    y_fused = compile_fused_partitioned(dense, plan, device="cpu")(x).numpy()
    y_seq = compile_partitioned(dense, plan, device="cpu")(x).numpy()
    for y in (y_fused, y_seq):
        assert_scaled_close(y, y_ref, 1e-4)
        assert_scaled_close(y, dense.astype(np.float64) @ x, 1e-4)


# ------------------------------------------------------------------ memo


def test_fused_memo_one_entry_per_plan_keyed_by_device():
    clear_kernel_memo()
    dense = hetero_matrix(256)
    _, plan = plan_pair(dense, ["csr", "ell"], 2)
    _, other = plan_pair(dense, ["csr", "ell"], 4)
    s0 = kernel_memo_stats()
    a = compile_spmv_fused(dense, plan, device="cpu", memo_key="m")
    b = compile_spmv_fused(dense, plan, device="cpu", memo_key="m")
    assert a is b
    s1 = kernel_memo_stats()
    assert (s1["compiles"] - s0["compiles"], s1["hits"] - s0["hits"]) == (1, 1)
    c = compile_spmv_fused(dense, other, device="cpu", memo_key="m")
    assert c is not a and kernel_memo_stats()["compiles"] - s0["compiles"] == 2
    from repro_torch.kernels import ops

    keys = [k for k in ops._KERNEL_MEMO if k[0] == "m"]
    assert {k[1] for k in keys} == {"fused:csr+ell", "fused:csr+ell+csr+ell"}
    assert all(k[3] == torch.device("cpu") for k in keys)
    assert fused_plan_signature(plan) in {k[2] for k in keys}
    # one constituent format retires every composite that contains it
    assert evict_kernel_memo_format("ell") == 2
    assert not [k for k in ops._KERNEL_MEMO if k[0] == "m"]
    assert compile_spmv_fused(dense, plan, device="cpu", memo_key="m") is not a
    clear_kernel_memo()


def test_unregistering_a_plugin_evicts_its_fused_composites(with_bcsr):
    from repro_torch.kernels import ops
    from repro_torch.sparse.registry import unregister_format

    clear_kernel_memo()
    dense = hetero_matrix(256)
    _, with_plugin = plan_pair(dense, ["bcsr", "csr"], 2)
    _, without = plan_pair(dense, ["sell", "csr"], 2)
    compile_spmv_fused(dense, with_plugin, device="cpu", memo_key="p")
    compile_spmv_fused(dense, without, device="cpu", memo_key="p")
    unregister_format("bcsr")
    assert [k[1] for k in ops._KERNEL_MEMO if k[0] == "p"] == ["fused:sell+csr"]
    clear_kernel_memo()
