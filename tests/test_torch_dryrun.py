"""The port's dry-run pieces (``repro_torch.launch.{hlo_analysis, specs,
dryrun}``) against the reference's: the HLO collective parser, analytic
model FLOPs and input specs for every arch x shape, per-device FLOP and
collective counting on DTensors of a fake process group (a toy, in a
subprocess), one small cell end to end on a ``cpu`` mesh, and the rule-set
error."""

import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import specs as ref_specs
from repro_torch.configs import get_config
from repro_torch.dist.sharding import abstract_mesh, spec_for
from repro_torch.launch import hlo_analysis, specs
from repro_torch.launch.dryrun import rule_set, run_cell
from repro_torch.models import cache_specs, model_specs
from repro_torch.models.param import torch_dtype, tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference test's sample (tests/test_dist_launch.py)
HLO_SAMPLE = """
  %all-gather.1 = bf16[16,512]{1,0} all-gather(bf16[16,32]{1,0} %p0), channel_id=1, replica_groups=[16,16]<=[256], dimensions={1}
  %all-reduce.2 = f32[128,64]{1,0} all-reduce(f32[128,64]{1,0} %p1), channel_id=2, replica_groups={{0,1,2,3}}, to_apply=%add
  %reduce-scatter.3 = f32[8,16]{1,0} reduce-scatter(f32[8,256]{1,0} %p2), channel_id=3, replica_groups=[1,16]<=[16], dimensions={1}
  %collective-permute.4 = bf16[4,4]{1,0} collective-permute(bf16[4,4]{1,0} %p3), channel_id=4, source_target_pairs={{0,1}}
  %fusion.9 = f32[2,2]{1,0} fusion(f32[2,2]{1,0} %p4), kind=kLoop
"""


def _env():
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": str(ROOT / "src")}


def test_parse_and_summarize_collectives_equal_the_references():
    ours, theirs = hlo_analysis.parse_collectives(HLO_SAMPLE), ref_hlo.parse_collectives(HLO_SAMPLE)
    assert [vars(o) for o in ours] == [vars(o) for o in theirs]
    assert sorted(o.kind for o in ours) == [
        "all-gather", "all-reduce", "collective-permute", "reduce-scatter"]
    ag = next(o for o in ours if o.kind == "all-gather")
    assert ag.group_size == 16 and ag.operand_bytes == ag.result_bytes // 16 == 16 * 32 * 2
    assert hlo_analysis.summarize_collectives(ours) == ref_hlo.summarize_collectives(theirs)
    for kind, g in (("all-reduce", 4), ("all-gather", 4), ("reduce-scatter", 8),
                    ("all-to-all", 16), ("collective-permute", 2), ("all-reduce", 1)):
        a = hlo_analysis.CollectiveOp(kind, "f32", 4000, 1000, g)
        assert a.ring_link_bytes == ref_hlo.CollectiveOp(kind, "f32", 4000, 1000, g).ring_link_bytes


def _spec_tree(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tree.items()}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_input_specs_equal_the_references(arch, shape):
    cfg, ref_cfg, ws = get_config(arch), ref_get_config(arch), SHAPES[shape]
    assert specs.model_flops(cfg, ws) == ref_specs.model_flops(ref_cfg, ws)
    for name in ("train_batch_specs", "prefill_input_specs", "decode_input_specs"):
        ours, theirs = getattr(specs, name)(cfg, ws), getattr(ref_specs, name)(ref_cfg, ws)
        assert all(v.device.type == "meta" for v in ours.values())
        assert _spec_tree(ours) == _spec_tree(theirs), name


_TOY = textwrap.dedent("""
    import json, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.dryrun import LocalCost, fake_process_group
    from repro_torch.launch.hlo_analysis import CollectiveRecorder

    R, S = Replicate(), Shard
    out = {}
    with fake_process_group(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        fake = FakeTensorMode()

        def run(name, la, lb, pa, pb, after=None):
            with fake:
                a, b = torch.empty(*la), torch.empty(*lb)
            A = DTensor.from_local(a, mesh, pa, run_check=False)
            B = DTensor.from_local(b, mesh, pb, run_check=False)
            cost, rec, comm = LocalCost(fake), CollectiveRecorder(), CommDebugMode()
            with fake, comm, rec, cost:
                C = A @ B
                if after is not None:
                    C = C.redistribute(mesh, after)
            out[name] = {"flops": cost.flops, "global": list(C.shape),
                         "ops": [vars(o) for o in cost.ops],
                         "recorded": [vars(o) for o in rec.ops],
                         "comm": comm.get_total_counts()}

        # 64 x 4096 @ 4096 x 16384: rows over data (16 ways), then over both axes
        run("sharded16", (4, 4096), (4096, 16384), [S(0), R], [R, R])
        run("sharded256", (4, 4096), (4096, 1024), [S(0), R], [R, S(1)])
        run("replicated", (64, 4096), (4096, 16384), [R, R], [R, R])
        # the contraction split over model: partial sums, then an all-reduce
        run("contracted", (64, 256), (256, 1024), [R, S(1)], [R, S(0)], [R, R])
        # rows over data, then gathered: an all-gather
        run("gathered", (4, 4096), (4096, 1024), [S(0), R], [R, R], [R, R])
    print(json.dumps(out))
""")


def test_toy_counts_are_per_device_and_collectives_match_comm_debug_mode():
    r = subprocess.run([sys.executable, "-c", _TOY], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    whole = 2 * 64 * 4096 * 16384  # the global product's FLOPs
    assert out["sharded16"]["flops"] == whole / 16
    assert out["sharded256"]["flops"] == 2 * 64 * 4096 * 16384 / 256
    assert out["replicated"]["flops"] == whole
    assert out["contracted"]["flops"] == 2 * 64 * 4096 * 1024 / 16
    for name, case in out.items():
        assert case["global"][0] == 64
        assert len(case["recorded"]) == len(case["ops"]) == case["comm"], name
        assert case["recorded"] == case["ops"], name
    assert [o["kind"] for o in out["contracted"]["ops"]] == ["all-reduce"]
    ar = out["contracted"]["ops"][0]
    assert ar == {"kind": "all-reduce", "dtype": "f32", "result_bytes": 64 * 1024 * 4,
                  "operand_bytes": 64 * 1024 * 4, "group_size": 16}
    ag = out["gathered"]["ops"][0]
    assert ag["kind"] == "all-gather" and ag["group_size"] == 16
    assert ag["operand_bytes"] == 4 * 1024 * 4 and ag["result_bytes"] == 64 * 1024 * 4
    assert out["sharded16"]["ops"] == out["replicated"]["ops"] == []


def _local_bytes(mesh, shape, axes, dtype, rules) -> int:
    sizes = mesh.shape
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    for entry in spec_for(mesh, shape, axes, rules):
        for name in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n //= sizes[name]
    return n


def test_one_small_cell_end_to_end_on_a_cpu_mesh(tmp_path):
    """qwen3-0.6b decode_32k on the 16 x 16 mesh of a fake 256-rank group:
    the reference's artifact keys, and argument bytes per device equal to
    the local shards' bytes that ``spec_for`` gives every argument."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b",
           "--shape", "decode_32k", "--mesh", "pod1", "--device-type", "cpu",
           "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    art = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod16x16.json").read_text())
    assert {"memory", "hbm_per_device_gb", "cost_pass", "roofline"} <= art.keys()
    assert art["n_chips"] == 256 and art["device_type"] == "cpu" and art["rules"] == "train"
    assert art["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert art["cost_pass"]["extrapolated_per_device"]["flops"] > 0
    cfg, ws = get_config("qwen3-0.6b"), SHAPES["decode_32k"]
    mesh, rules = abstract_mesh((16, 16), ("data", "model")), rule_set("train")
    want = sum(_local_bytes(mesh, s.shape, s.axes, torch_dtype(s.dtype or cfg.param_dtype), rules)
               for s in tree_leaves(model_specs(cfg)))
    want += sum(_local_bytes(mesh, s.shape, s.axes, torch_dtype(s.dtype or cfg.compute_dtype),
                             rules)
                for s in tree_leaves(cache_specs(cfg, ws.global_batch, ws.seq_len)))
    want += 2 * _local_bytes(mesh, (ws.global_batch, 1), ("batch", None), torch.int32, rules)
    assert art["memory"]["argument_bytes_per_device"] == want
    # the decode step returns the cache: outputs at least the cache's bytes
    assert art["memory"]["output_bytes_per_device"] > 0.9 * want
    # the extrapolation is affine in depth: it equals the full-depth count
    assert art["cost_pass"]["extrapolated_per_device"]["flops"] == pytest.approx(
        art["cost_pass"]["full_depth_per_device"]["flops"], rel=1e-9)


def test_unknown_rule_sets_raise_a_value_error_naming_them(tmp_path):
    """The reference's ``--rules`` choices include ``serve`` and
    ``train_sp``, which its ``RULE_SETS`` lacks: it raises ``KeyError``
    (run in a subprocess: importing its dry run sets ``XLA_FLAGS``). The
    port raises a ``ValueError`` that names the rule sets, before any mesh."""
    for name in ("serve", "train_sp"):
        with pytest.raises(ValueError, match=r"rule sets: \['infer', 'spmv', 'train'\]"):
            run_cell("qwen3-0.6b", "train_4k", False, tmp_path, rules_name=name)
    code = textwrap.dedent(f"""
        import pathlib
        from repro.launch import dryrun
        for name in ("serve", "train_sp"):
            try:
                dryrun.run_cell("qwen3-0.6b", "train_4k", False, pathlib.Path({str(tmp_path)!r}),
                                rules_name=name)
            except KeyError as e:
                print("KeyError", e)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["KeyError", "'serve'", "KeyError", "'train_sp'"]
    assert jax.devices()[0].platform == "cpu"  # this process kept its one device
