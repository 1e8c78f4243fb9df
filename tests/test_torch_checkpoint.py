"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's: the same layout and leaf keys, so a checkpoint written by
either package restores into the other bit for bit (bf16 and int32 leaves
included); keep-K, a stray ``tmp_`` directory, and the errors."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import model_specs as ref_model_specs
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.models import params_from_numpy
from repro_torch.models.param import params_to_numpy


def _tree():
    """A mixed tree: float32, bf16, int32 (a 0-d step), nested tuples/lists."""
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.linspace(-3, 3, 4).to(torch.bfloat16),
                  torch.tensor(2, dtype=torch.int32)],
            "c": ({"w": torch.randn(3, 2, generator=torch.Generator().manual_seed(0))}, ())}


def _assert_trees_equal(a, b):
    fa, fb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(fa[k].view(torch.int16) if fa[k].dtype == torch.bfloat16 else fa[k],
                           fb[k].view(torch.int16) if fb[k].dtype == torch.bfloat16 else fb[k]), k


def _ref_train_state(bf16_moments=False):
    """A reference (params, opt_state) of a reduced MoE model: bf16 params
    and, optionally, bf16 moments."""
    cfg = ref_get_config("deepseek-moe-16b", reduced_config=True).replace(param_dtype="bfloat16")
    params = ref_init_params(ref_model_specs(cfg), jax.random.PRNGKey(0), cfg.param_dtype)
    opt = ref_init_opt_state(params, RefAdamWConfig(
        state_dtype="bfloat16" if bf16_moments else "float32"))
    opt = dict(opt, m=jax.tree.map(lambda m: (m + 0.125).astype(m.dtype), opt["m"]),
               step=jnp.asarray(7, jnp.int32))
    return params, opt


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    for step in (10, 20, 30):
        mgr.save(step, tree, {"next_step": step})
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    restored, extra = mgr.restore(tree)
    assert extra == {"next_step": 30}
    _assert_trees_equal(restored, tree)
    manifest = json.loads((tmp_path / "step_00000030" / "manifest.json").read_text())
    assert manifest["leaves"]["b//0"] == {"dtype": "bfloat16", "shape": [4]}
    assert manifest["leaves"]["b//1"] == {"dtype": "int32", "shape": []}
    restored, _ = mgr.restore(tree, step=20)
    _assert_trees_equal(restored, tree)


def test_checkpoint_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.ones(3)})
    (tmp_path / "tmp_2").mkdir()  # a stale tmp dir from a crashed save
    (tmp_path / "tmp_2" / "junk").write_text("x")
    mgr.save(2, {"x": torch.zeros(3)})
    assert mgr.latest_step() == 2 and mgr.all_steps() == [1, 2]
    assert not (tmp_path / "tmp_2").exists()


def test_checkpoint_errors(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.ones(3)})
    mgr.save(1, {"x": torch.ones(3)})
    with pytest.raises(KeyError, match="y"):
        mgr.restore({"x": torch.ones(3), "y": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"x": torch.ones(4)})


def test_leaf_keys_are_the_references(tmp_path):
    params, opt = _ref_train_state()
    ref_keys = set(json.loads(
        (RefCheckpointManager(tmp_path / "r").save(3, (params, opt)) / "manifest.json")
        .read_text())["leaves"])
    port_tree = params_from_numpy(jax.tree.map(np.asarray, (params, opt)), "cpu")
    port_keys = set(json.loads(
        (CheckpointManager(tmp_path / "p").save(3, port_tree) / "manifest.json")
        .read_text())["leaves"])
    assert port_keys == ref_keys and "0//groups//0//moe//w_up" in port_keys


@pytest.mark.parametrize("bf16_moments", [False, True])
def test_reference_written_restores_into_the_port_bit_for_bit(tmp_path, bf16_moments):
    params, opt = _ref_train_state(bf16_moments)
    RefCheckpointManager(tmp_path).save(5, (params, opt), {"next_step": 5})
    want = params_from_numpy(jax.tree.map(np.asarray, (params, opt)), "cpu")
    like = jax.tree.map(torch.zeros_like, want)
    got, extra = CheckpointManager(tmp_path).restore(like)
    assert extra == {"next_step": 5}
    _assert_trees_equal(got, want)
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 7


@pytest.mark.parametrize("bf16_moments", [False, True])
def test_port_written_restores_into_the_reference_bit_for_bit(tmp_path, bf16_moments):
    params, opt = _ref_train_state(bf16_moments)
    port_tree = params_from_numpy(jax.tree.map(np.asarray, (params, opt)), "cpu")
    CheckpointManager(tmp_path).save(9, port_tree, {"next_step": 9})
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), (params, opt))
    got, extra = RefCheckpointManager(tmp_path).restore(like)
    assert extra == {"next_step": 9}
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, (params, opt)))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a,
                                      b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16 else b)


def test_params_to_numpy_is_the_inverse_of_params_from_numpy():
    tree = _tree()
    back = params_to_numpy(tree)
    assert back["b"][0].dtype == ml_dtypes.bfloat16 and back["b"][1].dtype == np.int32
    _assert_trees_equal(params_from_numpy(back, "cpu"), tree)


def test_restore_places_leaves_by_shardings(tmp_path):
    """``shardings=``: a leaf with a ``torch.device`` or a ``NamedSharding``
    over a local mesh goes there, the same bits; ``None`` leaves (and
    leaves the tree lacks) follow ``target_like``."""
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    from repro_torch.launch.mesh import make_host_mesh

    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(1, tree)
    host = NamedSharding(make_host_mesh("cpu"), PartitionSpec())
    shardings = {"a": torch.device("cpu"), "b": [host, None], "c": ({"w": host}, ())}
    restored, _ = mgr.restore(tree, shardings=shardings)
    _assert_trees_equal(restored, tree)
    partial, _ = mgr.restore(tree, shardings={"a": "cpu"})
    _assert_trees_equal(partial, tree)
    # the reference keeps the same signature
    import inspect

    assert list(inspect.signature(RefCheckpointManager.restore).parameters) == list(
        inspect.signature(CheckpointManager.restore).parameters)


@pytest.fixture
def one_rank_mesh():
    """A 1-rank gloo process group over a ``HashStore`` and a (1, 1)
    ``("data", "model")`` DeviceMesh on it, destroyed after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_restore_onto_a_device_mesh_gives_dtensors_of_the_same_bits(tmp_path, one_rank_mesh):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import build_sharding, place
    from repro_torch.models import init_params, model_specs

    cfg = get_config("qwen3-0.6b", reduced_config=True)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0), "float32", "cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, params)
    sh = build_sharding(one_rank_mesh, model_specs(cfg))
    restored, _ = mgr.restore(params, shardings=sh)
    leaves = _flatten_with_paths(restored)
    assert all(isinstance(t, DTensor) and t.device_mesh is one_rank_mesh for t in leaves.values())
    _assert_trees_equal({k: t.full_tensor() for k, t in leaves.items()},
                        _flatten_with_paths(params))
    # a DTensor tree saves whole (gathered) and restores as plain tensors
    mgr.save(4, restored)
    plain, _ = mgr.restore(params, step=4)
    _assert_trees_equal(plain, params)
    w = params["embed"]
    assert torch.equal(place(w, sh["embed"]).full_tensor(), w)
