"""The port's distribution substrate (``repro_torch.dist``) against the
reference's ``repro.dist``: ``spec_for`` for every parameter of every full
config on both production meshes, the reference's own sharding cases,
batch and SpMV rules, DTensor placements (pod-major), ``hint`` outside a
context, and ``models.{abstract_params, axes_tree}``."""

import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.dist.sharding import RULE_SETS as REF_RULE_SETS
from repro.dist.sharding import abstract_mesh as ref_abstract_mesh
from repro.dist.sharding import batch_sharding as ref_batch_sharding
from repro.dist.sharding import spec_for as ref_spec_for
from repro.dist.sharding import spmv_mesh as ref_spmv_mesh
from repro.models import abstract_params as ref_abstract_params
from repro.models import axes_tree as ref_axes_tree
from repro.models import model_specs as ref_model_specs
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.dist import RULE_SETS, abstract_mesh, batch_sharding, hint, sharding_context, spec_for
from repro_torch.dist.sharding import (
    SPMV_RULES,
    NamedSharding,
    PartitionSpec,
    build_sharding,
    placements_for,
    spmv_mesh,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import abstract_params, axes_tree, model_specs

MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    sizes, names = MESHES[name]
    return abstract_mesh(sizes, names), ref_abstract_mesh(sizes, names)


def _leaves(tree):
    """``{path: leaf}`` of a spec tree of either package (dicts, tuples and
    lists, keyed as the checkpoints key them)."""
    return _flatten_with_paths(tree)


def test_rule_sets_are_the_references():
    assert RULE_SETS == REF_RULE_SETS and SPMV_RULES == REF_RULE_SETS["spmv"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("rules", ["train", "infer"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_every_parameter_of_every_config(arch, rules, mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    ours = _leaves(model_specs(get_config(arch)))
    theirs = _leaves(ref_model_specs(ref_get_config(arch)))
    assert ours.keys() == theirs.keys() and len(ours) > 5
    sharded = 0
    for key, s in ours.items():
        r = theirs[key]
        assert (s.shape, s.axes) == (r.shape, r.axes), key
        got = spec_for(mesh, s.shape, s.axes, RULE_SETS[rules])
        want = ref_spec_for(ref_mesh, r.shape, r.axes, REF_RULE_SETS[rules])
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == tuple(want), (key, got, want)
        sharded += bool(tuple(got))
    assert sharded > 0


# the reference's tests/test_dist_launch.py sharding cases
SHARDING_CASES = {
    "fsdp_tp_weight": [("pod16x16", (4096, 32, 128), ("embed", "heads", None), ("data", "model")),
                       ("pod2x16x16", (4096, 32, 128), ("embed", "heads", None),
                        (("pod", "data"), "model"))],
    "kv_heads_replicated_when_indivisible": [
        ("pod16x16", (4096, 8, 128), ("embed", "kv", None), ("data",)),
        ("pod16x16", (4096, 32, 128), ("embed", "kv", None), ("data", "model"))],
    "duplicate_axis_not_reused": [("pod16x16", (2048, 2048), ("embed", "embed"), ("data",))],
    "vocab_sharding": [("pod16x16", (128256, 4096), ("vocab", "embed"), ("model", "data"))],
    "indivisible_batch_replicated": [("pod2x16x16", (1, 128), ("batch", None), ())],
}


@pytest.mark.parametrize("case", sorted(SHARDING_CASES))
def test_reference_sharding_cases(case):
    for mesh_name, shape, axes, want in SHARDING_CASES[case]:
        mesh, ref_mesh = _meshes(mesh_name)
        got = spec_for(mesh, shape, axes)
        assert tuple(got) == want == tuple(ref_spec_for(ref_mesh, shape, axes))
        assert got == PartitionSpec(*want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_sharding_matches_the_reference(mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    shapes = {"tokens": (256, 4096), "labels": (256, 4096), "embeds": (32, 8, 64),
              "one": (1, 128), "odd": (48, 3)}
    ours = batch_sharding(mesh, {k: torch.empty(s, device="meta") for k, s in shapes.items()})
    theirs = ref_batch_sharding(
        ref_mesh, {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()})
    for k in shapes:
        assert isinstance(ours[k], NamedSharding) and ours[k].mesh is mesh
        assert tuple(ours[k].spec) == tuple(theirs[k].spec), k


def test_build_sharding_keeps_the_tree():
    mesh, _ = _meshes("pod16x16")
    specs = model_specs(get_config("qwen3-0.6b"))
    sh = build_sharding(mesh, specs)
    assert _leaves(sh).keys() == _leaves(specs).keys()
    assert tuple(sh["embed"].spec) == ("model", "data")


def test_spmv_rules_map_blocks_to_data_axis():
    """The reference's test_partition_multidevice case, on a 1-entry mesh
    of each package (the port's on the CPU, asked for by name)."""
    mesh, ref_mesh = spmv_mesh(1, device="cpu"), ref_spmv_mesh(1)
    assert mesh.shape == {"data": 1} == dict(ref_mesh.shape)
    for shape, axes, want in (((4, 8, 16), ("blocks", None, None), ("data",)),
                              ((64,), (None,), ())):
        assert tuple(spec_for(mesh, shape, axes, SPMV_RULES)) == want
        assert tuple(ref_spec_for(ref_mesh, shape, axes, SPMV_RULES)) == want
    assert spec_for(mesh, (4, 8, 16), ("blocks", None, None), SPMV_RULES) == PartitionSpec("data")
    assert RefP("data") == ref_spec_for(ref_mesh, (4, 8, 16), ("blocks", None, None), SPMV_RULES)


def test_spmv_mesh_never_picks_the_cpu_by_itself():
    assert not torch.cuda.is_available()
    for call in (lambda: spmv_mesh(2), lambda: spmv_mesh(2, "cuda"), lambda: make_host_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    cpu = spmv_mesh(4, device="cpu")
    assert cpu.devices == [torch.device("cpu")] * 4 and cpu.shape == {"data": 4}
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1} and host.devices == [torch.device("cpu")]


def test_placements_shard_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = _meshes("pod2x16x16")
    spec = spec_for(mesh, (4096, 32, 128), ("embed", "heads", None))
    assert placements_for(mesh, spec, 3) == [Shard(0), Shard(0), Shard(1)]
    assert placements_for(mesh, PartitionSpec(), 2) == [Replicate()] * 3
    assert placements_for(mesh, PartitionSpec(None, "model"), 2) == [
        Replicate(), Replicate(), Shard(1)]


def test_dtensor_places_a_pod_data_dim_pod_major_as_jax_does(tmp_path):
    """On a (2, 2) ``("pod", "data")`` mesh of a fake 4-rank group, rank
    (p, d) holds block ``2 p + d`` of a dim sharded over ("pod", "data"):
    DTensor's own chunking and a replicated tensor redistributed to the
    placements (how ``local_shards`` cuts a plain argument) both, as JAX
    lays out ``P(("pod", "data"))`` over the same device grid."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(_src())!r})
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.dist.sharding import PartitionSpec, placements_for
        full = torch.arange(8.0)
        out = []
        for rank in range(4):
            dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
            pl = placements_for(mesh, PartitionSpec(("pod", "data")), 1)
            a = distribute_tensor(full, mesh, pl, src_data_rank=None).to_local()
            b = DTensor.from_local(full, mesh, [Replicate()] * 2, run_check=False)
            b = b.redistribute(mesh, pl).to_local()
            out.append((tuple(mesh.get_coordinate()), a.tolist(), b.tolist()))
            dist.destroy_process_group()
        print(out)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = eval(r.stdout.strip().splitlines()[-1])
    for (p, d), a, b in got:
        blk = 2 * p + d
        assert a == b == [2.0 * blk, 2.0 * blk + 1]
    assert sorted(c for c, _, _ in got) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # JAX's layout of the same spec over a (2, 2) grid of four host devices
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        grid = np.asarray(jax.devices()[:4]).reshape(2, 2)
        idx = NamedSharding(Mesh(grid, ("pod", "data")), P(("pod", "data"))).devices_indices_map((8,))
        print([(p, d, idx[grid[p, d]][0].start) for p in range(2) for d in range(2)])
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    starts = eval(r.stdout.strip().splitlines()[-1])
    assert starts == [(p, d, 2 * (2 * p + d)) for p in range(2) for d in range(2)]


def test_hint_is_the_identity_outside_a_context_and_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    assert hint(x, ("batch", "seq", None)) is x
    with sharding_context(make_host_mesh("cpu")):
        assert hint(x, ("batch", "seq", None)) is x
    with sharding_context(abstract_mesh((16, 16), ("data", "model")), RULE_SETS["infer"]):
        assert hint(x, ("batch", None, "vocab")) is x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_axes_tree_match_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    ours = _leaves(abstract_params(model_specs(cfg), cfg.param_dtype))
    theirs = _leaves(ref_abstract_params(ref_model_specs(ref_cfg), ref_cfg.param_dtype))
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        r = theirs[k]
        assert t.device.type == "meta" and tuple(t.shape) == tuple(r.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), k
    ax, ref_ax = axes_tree(model_specs(cfg)), ref_axes_tree(ref_model_specs(ref_cfg))
    assert _leaves(ax) == _leaves(ref_ax)


def _src():
    import pathlib

    return pathlib.Path(__file__).resolve().parents[1] / "src"
