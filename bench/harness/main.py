"""One run of one cell: set up, warm up, measure, check, print the result.

``main`` is the command line; ``run_cell`` is the run itself on a given
device, which the tests drive on the CPU at small sizes. The result is the
last line of standard output, one JSON object; the numbers compared with
their limits are the last lines of standard error and the last key of the
result."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass

import torch

from bench.harness.catalog import Catalog
from bench.harness.energy import BoardEnergy
from bench.harness.profile import Profile
from bench.harness.window import Sampler, Window, WindowEnd, sync

# top-level module names that no run may hold once its window has closed:
# the JAX package the port was made from, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py: read(run)``)."""

    cell: str
    client: str
    setup: dict  # seconds: setup_s, tuner_build_s, first_answer_s
    window: Window
    profile: Profile | None
    work: tuple[int, int]  # bytes, operations one step needs
    products_per_step: int


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def run_cell(catalog: Catalog, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, *, control: bool = False, tuner=None):
    """Returns ``(result dict, check dict, system)``; the system's program
    state is freed, its description and reference kept."""
    cell = catalog.cell(cell_name)
    cfg, mix, limits = catalog.config(cell), catalog.traffic(cell), catalog.limits(cell)
    client = catalog.module("clients", mix["client"])
    system = catalog.module("systems", cfg["system"]).System(
        cfg, mix, seed, device, control=control, tuner=tuner)
    if device.type == "cuda":
        torch.empty(0, device=device)  # the context and its allocator, before the reset
        torch.cuda.reset_peak_memory_stats(device)
    energy = BoardEnergy.open(device) if device.type == "cuda" else None
    try:
        system.inputs()
        t = time.perf_counter()
        system.build_tuner()
        tuner_build_s = time.perf_counter() - t
        t = time.perf_counter()
        system.first_answer()
        sync(device)
        first_answer_s = time.perf_counter() - t
        client.warm(system, mix)
        setup = {"setup_s": time.perf_counter() - t_start, "tuner_build_s": tuner_build_s,
                 "first_answer_s": first_answer_s}
        window = client.run(system, mix, WindowEnd(seconds, energy),
                            Sampler(seed, mix["sample_gap"]), trace)
        prof = client.profile(system, mix) if trace else None
    finally:
        if energy is not None:
            energy.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    described = system.describe()
    samples = [(i, tuple(o.detach().cpu().numpy() for o in outs)) for i, outs in window.samples]
    window.samples = []
    system.release()
    check, failed = judge(system, samples, limits["check"])
    run = Run(cell.name, mix["client"], setup, window, prof, system.work,
              system.products_per_step)
    metrics = {}
    for m in catalog.metrics_for(cell, trace):
        value = catalog.reader(m.name)(run)
        if value is None:
            print(f"metric {m.name}: nothing to read in this run", file=sys.stderr)
        else:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"] for c in check.values()),
              "attempted": window.products, "failed": failed, "metrics": metrics,
              "device": dev}
    if prof is not None:
        dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = {"device_ops": prof.device_ops, "idle_gaps": prof.idle_gaps}
    result["served"] = described
    result["check"] = check
    return result, check, system


def judge(system, samples, limits: dict) -> tuple[dict, int]:
    """The kept answers against the reference: the largest relative gap of
    any of them (``inf`` for an answer of the wrong shape or not finite),
    and how many answers lie beyond the limit."""
    from bench.reference.products import max_rel_err

    worst, failed = 0.0, 0
    for i, outs in samples:
        ref = system.reference(i)
        errs = [max_rel_err(o, r) for o, r in zip(outs, ref)] if len(outs) == len(ref) else [math.inf]
        err = max(errs)
        worst = max(worst, err)
        failed += int(err > limits["max_rel_err"])
    return {"max_rel_err": {"value": worst, "limit": limits["max_rel_err"]},
            "answers_missing": {"value": int(not samples), "limit": 0}}, failed


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench/run.py", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    catalog = Catalog.load()
    cell = catalog.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"refused: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result, check, _ = run_cell(catalog, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"refused: the run imported {bad}", file=sys.stderr)
        return 3
    for name, c in check.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
