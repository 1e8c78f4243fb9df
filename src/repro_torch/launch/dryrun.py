"""Multi-pod dry run: ``python -m repro_torch.launch.dryrun --arch <id>
--shape <name> [--mesh pod1|pod2|both] [--device-type cuda|cpu]``.

For every (architecture x workload shape x mesh) cell, in one process that
holds no fleet:

1. A ``FakeStore`` process group of 256 (16 x 16) or 512 (2 x 16 x 16)
   ranks is opened in the dry run's own process (never at import), the
   production ``DeviceMesh`` built on it (``launch.mesh``), and the step's
   arguments made as DTensors of fake tensors placed by the rules
   (``dist.sharding``). The step runs under ``FakeTensorMode``,
   ``implicit_replication`` (the model makes plain tensors: positions,
   masks, RoPE tables; they join DTensor ops replicated) and
   ``sharding_context`` (so ``hint`` pins the reference's activations).
   DTensor stands in for GSPMD: a failure here (no sharding rule, a
   placement mismatch) is a bug in the framework, not in the cell.
2. **Memory pass** at full depth, per device (rank 0's shards): argument
   and output bytes exactly, from the local shards; temp bytes as the peak
   of live local bytes the step allocates, less its outputs. It cannot see
   the caching allocator's slack, NCCL's buffers or the CUDA context.
3. **Cost pass** at 1 and 2 pattern repetitions, extrapolated linearly to
   the full depth (a step's cost is affine in depth), as the reference
   does to bound its compile time; here it bounds the dry run's wall time.
   Everything is counted per device on the local ops DTensor runs, as the
   reference's ``cost_analysis()`` is per device: FLOPs by PyTorch's
   formulas at the local shapes (a global ``FlopCounterMode`` would count
   DTensor ops at their global shapes), bytes as each eager op's inputs
   plus outputs, collectives as DTensor emits them
   (``hlo_analysis.CollectiveRecorder``).
4. **Roofline terms** — compute / memory / collective seconds against an
   NVIDIA H100 SXM's data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
   80 GB of HBM; the collective term at 50 GB/s per GPU per direction,
   NDR InfiniBand (400 Gb/s): every 16-wide mesh axis spans two or more
   8-GPU nodes, so NVLink's 450 GB/s per direction bounds none of these
   meshes' collectives.

On the card's machine the mesh is a ``cuda`` mesh, so that all-to-all
stays all-to-all; a ``cpu`` mesh (``--device-type cpu``, for machines
without a card) makes DTensor fall back to all-gather + chunk, so its
collective counts are not a CUDA mesh's. Nothing here swaps one for the
other. Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys (``memory``, ``hbm_per_device_gb``,
``cost_pass``, ``roofline``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.partition import sharding_context
from repro_torch.dist.sharding import (
    RULE_SETS,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    build_sharding,
    placements_for,
)
from repro_torch.launch.hlo_analysis import CollectiveRecorder, collectives_of, summarize_collectives
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import make_step_fn, model_flops
from repro_torch.models import cache_specs, model_specs
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.utils.logging import get_logger

log = get_logger("dryrun")

# NVIDIA H100 SXM, data sheet (dense, no sparsity; at its 700 W limit)
PEAK_FLOPS = 989e12  # bf16 tensor cores per GPU
HBM_BW = 3.35e12  # bytes/s per GPU, HBM3
HBM_BYTES = 80e9  # per GPU
LINK_BW = 50e9  # bytes/s per GPU per direction: NDR InfiniBand, 400 Gb/s
HARDWARE = {"name": "NVIDIA H100 SXM (data sheet)", "peak_flops_bf16": PEAK_FLOPS,
            "hbm_bytes_per_s": HBM_BW, "hbm_bytes": HBM_BYTES, "link_bytes_per_s": LINK_BW,
            "link": "NDR InfiniBand, 400 Gb/s per GPU"}

OUT_DIR = "artifacts/dryrun_torch"
# ops that move no bytes of their own
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided", "detach", "alias", "lift_fresh"})


def rule_set(name: str) -> dict:
    if name not in RULE_SETS:
        raise ValueError(f"no sharding rule set {name!r}; rule sets: {sorted(RULE_SETS)}")
    return RULE_SETS[name]


@contextmanager
def fake_process_group(world_size: int):
    """A ``FakeStore`` process group of ``world_size`` ranks, this process
    rank 0, torn down on exit: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class LocalCost(CollectiveRecorder):
    """Per-device cost of what runs while it is active: FLOPs, bytes, live
    and peak bytes, collectives — all read from the local ops DTensor runs
    on this rank's shards, and from plain-tensor ops, which every rank runs
    whole.

    DTensor's sharding propagation runs each new op once on fake tensors of
    the global shapes, inside a nested entry of the active
    ``FakeTensorMode``; ops seen at a deeper entry than the mode's own are
    that propagation and count nothing."""

    def __init__(self, fake_mode):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.fake_mode = fake_mode
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()

    def __enter__(self):
        self._depth = len(self.fake_mode.enter_stack)
        return super().__enter__()

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if len(self.fake_mode.enter_stack) > self._depth:
            return out  # sharding propagation at the global shapes
        self.ops.extend(collectives_of(func, args, kwargs))
        pkt = func._overloadpacket
        if pkt in self.flop_registry:
            self.flops += self.flop_registry[pkt](*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if (not outs or func.namespace in ("_c10d_functional", "prim") or _is_view(func)
                or pkt.__name__ in _NO_TRAFFIC):
            if func.namespace == "_c10d_functional":
                self._track(outs)
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._track(outs)
        return out


def _shardings_for(cfg: ModelConfig, shape, mesh, args, rules=None):
    """in/out shardings matching make_step_fn's argument tree."""
    param_sh = build_sharding(mesh, model_specs(cfg), rules)
    if shape.kind == "train":
        opt_sh = {"m": param_sh, "v": param_sh, "step": NamedSharding(mesh, PartitionSpec())}
        batch_sh = batch_sharding(mesh, args[2])
        return (param_sh, opt_sh, batch_sh), (param_sh, opt_sh, None)
    cache_sh = build_sharding(mesh, cache_specs(cfg, shape.global_batch, shape.seq_len), rules)
    if shape.kind == "prefill":
        return (param_sh, cache_sh, batch_sharding(mesh, args[2])), (None, cache_sh)
    tok_sh = batch_sharding(mesh, {"t": args[2]})["t"]
    pos_sh = batch_sharding(mesh, {"p": args[3]})["p"]
    return (param_sh, cache_sh, tok_sh, pos_sh), (None, cache_sh)


def _local_shape(shape, mesh, placements) -> tuple[int, ...]:
    from torch.distributed.tensor import Shard

    out = list(shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            out[p.dim] //= size  # spec_for shards only dims the extent divides
    return tuple(out)


def _distribute(meta: torch.Tensor, sharding: NamedSharding, device_type: str):
    """A DTensor of a fake local shard of ``meta``'s shape, placed by
    ``sharding`` (call inside the fake mode)."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = placements_for(mesh, sharding.spec, meta.ndim)
    local = torch.empty(_local_shape(meta.shape, mesh, placements), dtype=meta.dtype,
                        device=device_type)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _constrain(outs: tuple, out_sh: tuple) -> tuple:
    """Redistribute the step's outputs to ``out_sh`` (``None``: as they
    come), as the reference's ``out_shardings`` do."""
    from torch.distributed.tensor import DTensor

    def one(sh, t):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(sh.mesh, placements_for(sh.mesh, sh.spec, t.ndim))

    return tuple(o if sh is None else tree_map(one, sh, o) for o, sh in zip(outs, out_sh))


def _depth_config(cfg: ModelConfig, reps: int) -> ModelConfig:
    n = len(cfg.first_blocks) + len(cfg.pattern) * reps + len(cfg.tail_blocks)
    return cfg.replace(n_layers=n)


def run_step(cfg, shape, mesh, *, rules=None, device_type: str = "cuda",
             unroll: bool = False) -> dict:
    """One step of the cell on fake DTensors; its per-device cost."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    step, args = make_step_fn(cfg, shape, unroll=unroll)
    in_sh, out_sh = _shardings_for(cfg, shape, mesh, args, rules)
    t0 = time.perf_counter()
    fake = FakeTensorMode()
    with fake:
        dargs = tree_map(lambda a, s: _distribute(a, s, device_type), args, in_sh)
    cost = LocalCost(fake)
    with fake, implicit_replication(), sharding_context(mesh, rules), cost:
        outs = _constrain(step(*dargs), out_sh)
    out_leaves = [t for t in tree_leaves(outs) if isinstance(t, torch.Tensor)]
    arg_bytes = sum(_nbytes(_local(t)) for t in tree_leaves(dargs))
    out_bytes = sum(_nbytes(_local(t)) for t in out_leaves)
    return {
        "seconds": time.perf_counter() - t0,
        "flops": float(cost.flops),
        "bytes": float(cost.bytes),
        "collectives": summarize_collectives(cost.ops),
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": max(cost.peak - out_bytes, 0),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             dispatch_format: str | None = None, tag: str = "",
             rules_name: str = "train", device_type: str = "cuda") -> dict:
    cfg = get_config(arch)
    if dispatch_format and cfg.n_experts:
        cfg = cfg.replace(dispatch_format=dispatch_format)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    ok, reason = applicable(cfg, shape_name)
    artifact: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": [2, 16, 16] if multi_pod else [16, 16],
        "n_chips": 512 if multi_pod else 256,
        "tag": tag,
        "device_type": device_type,
        "hardware": HARDWARE,
    }
    out_path = out_dir / f"{cell}.json"
    if not ok:
        artifact["skipped"] = reason
        out_path.write_text(json.dumps(artifact, indent=1))
        log.info("SKIP %s: %s", cell, reason)
        return artifact

    rules = rule_set(rules_name)
    artifact["rules"] = rules_name
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    n_chips = artifact["n_chips"]

    # ---- 1) full-depth proof + memory pass --------------------------------
    full = run_step(cfg, shape, mesh, rules=rules, device_type=device_type)
    print(f"[{cell}] memory per device:", {k: full[k] for k in
                                          ("argument_bytes", "output_bytes", "temp_bytes")})
    artifact["step_s_full"] = round(full["seconds"], 2)
    artifact["memory"] = {
        "argument_bytes_per_device": full["argument_bytes"],
        "output_bytes_per_device": full["output_bytes"],
        "temp_bytes_per_device": full["temp_bytes"],
        "unseen": "caching-allocator slack, NCCL buffers, the CUDA context",
    }
    total = full["argument_bytes"] + full["output_bytes"] + full["temp_bytes"]
    artifact["hbm_per_device_gb"] = round(total / 2**30, 3)
    artifact["fits_hbm"] = total <= HBM_BYTES

    # ---- 2) cost pass: depth-1 / depth-2, linear extrapolation ------------
    costs = {}
    for reps in (1, 2):
        c = run_step(_depth_config(cfg, reps), shape, mesh, rules=rules,
                     device_type=device_type, unroll=True)
        coll = c["collectives"]
        costs[reps] = {
            "flops": c["flops"],
            "bytes": c["bytes"],
            "coll_operand": float(coll["operand_bytes"]),
            "coll_ring": float(coll["ring_link_bytes"]),
            "coll_by_kind": coll["by_kind"],
            "step_s": round(c["seconds"], 2),
        }
    G = cfg.n_groups

    def extrap(key):
        c1, c2 = costs[1][key], costs[2][key]
        return c1 + (G - 1) * (c2 - c1)

    flops_dev = extrap("flops")
    bytes_dev = extrap("bytes")
    coll_operand_dev = extrap("coll_operand")
    coll_ring_dev = extrap("coll_ring")
    artifact["cost_pass"] = {
        "per_rep": {str(k): {kk: vv for kk, vv in v.items() if kk != "coll_by_kind"}
                    for k, v in costs.items()},
        "collectives_by_kind_rep2": {
            k: {"count": v["count"], "operand_bytes": int(v["operand_bytes"])}
            for k, v in costs[2]["coll_by_kind"].items()
        },
        "collectives_by_kind_full": {
            k: {"count": v["count"], "operand_bytes": int(v["operand_bytes"])}
            for k, v in full["collectives"]["by_kind"].items()
        },
        "extrapolated_per_device": {
            "flops": flops_dev,
            "bytes": bytes_dev,
            "collective_operand_bytes": coll_operand_dev,
            "collective_ring_link_bytes": coll_ring_dev,
        },
        "full_depth_per_device": {"flops": full["flops"], "bytes": full["bytes"]},
    }

    # ---- 3) roofline terms -------------------------------------------------
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_operand_dev / LINK_BW  # assignment formula
    collective_ring_s = coll_ring_dev / LINK_BW  # ring-schedule refinement
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = flops_dev * n_chips
    artifact["roofline"] = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "collective_ring_s": collective_ring_s,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": mf / hlo_flops_global if hlo_flops_global else 0.0,
        "step_time_lower_bound_s": max(terms.values()),
        "roofline_fraction": (mf / n_chips / PEAK_FLOPS) / max(max(terms.values()), 1e-30),
    }
    out_path.write_text(json.dumps(artifact, indent=1))
    log.info(
        "%s: dominant=%s compute=%.3gs memory=%.3gs coll=%.3gs useful=%.2f%% roofline=%.1f%% "
        "hbm=%.2f GB/device",
        cell, dominant, compute_s, memory_s, collective_s,
        100 * artifact["roofline"]["useful_flops_ratio"],
        100 * artifact["roofline"]["roofline_fraction"], artifact["hbm_per_device_gb"],
    )
    return artifact


def _iter_cells(archs, shapes, meshes):
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                yield arch, shape, mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true", help="run every cell in subprocesses")
    ap.add_argument("--dispatch-format", default=None, help="MoE dispatch override")
    ap.add_argument("--tag", default="", help="artifact suffix for perf experiments")
    ap.add_argument("--rules", default="train", choices=["train", "serve", "train_sp"],
                    help="sharding rule set (serve = TP-only weights)")
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the mesh (cpu: machines without a card)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]
    if args.all:
        archs = [args.arch] if args.arch else list(ARCH_IDS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        failures = []
        for arch, shape, mp in _iter_cells(archs, shapes, meshes):
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape,
                "--mesh", "pod2" if mp else "pod1", "--out", str(out_dir),
                "--rules", args.rules, "--device-type", args.device_type,
            ]
            if args.dispatch_format:
                cmd += ["--dispatch-format", args.dispatch_format]
            if args.tag:
                cmd += ["--tag", args.tag]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures.append((arch, shape, mp))
                log.error("FAILED %s %s %s:\n%s", arch, shape, mp, r.stderr[-2000:])
            else:
                log.info("ok %s %s %s", arch, shape, "pod2" if mp else "pod1")
        if failures:
            log.error("%d cells failed: %s", len(failures), failures)
            sys.exit(1)
        log.info("all cells passed")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    for mp in meshes:
        try:
            with fake_process_group(512 if mp else 256):
                run_cell(args.arch, args.shape, mp, out_dir,
                         dispatch_format=args.dispatch_format, tag=args.tag,
                         rules_name=args.rules, device_type=args.device_type)
        except Exception:
            traceback.print_exc()
            sys.exit(1)


if __name__ == "__main__":
    main()
