#!/usr/bin/env python3
"""The program's own spans on one benchmark cell, read from outside the harness.

    python3 tools/trace_stretch.py --workload gene2.stream --seed 12345 [--turns 2]

On the card, from the root of a checkout: stands the cell of ``BENCHMARK.json``
up as ``bench/run.py`` does (its ``systems`` and ``clients`` modules), with the
port's tracer (``repro_torch.obs.trace``) on for the tuner's build and the first
answer; then, after the client's warm pass:

* the client's two profiled stretches (``client.profile``, tracer off), for
  ``device_idle_share`` as the benchmark reads it;
* ``--turns`` rounds of four stretches of ``profile_steps`` calls in the
  window's cadence, the tracer off, on, on, off: the host time inside the
  program's calls, per product, with the tracer off (``dispatch_us`` as the
  benchmark reads it) and on (the tracing's own cost is the difference);
* the spans of the last stretch with the tracer on, read by the functions
  below.

Prints one JSON object and writes it to
``build/trace_stretch_<cell>_<seed>.json``. The readers take a stretch's
spans (dicts as ``Tracer.spans()`` gives them) and return ``None`` where the
spans lack the names they read (a program without these spans) or where the
tracer dropped spans or device times (``dropped``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _named(spans: list[dict], name: str) -> list[dict]:
    return [s for s in spans if s["name"] == name]


def _per_product_us(spans: list[dict], name: str, products: int, dropped: bool):
    hits = _named(spans, name)
    if dropped or not hits or products <= 0:
        return None
    return sum(s["dur_s"] for s in hits) / products * 1e6


def served_call_us(spans: list[dict], products: int, dropped: bool = False):
    """Host time inside ``spmv.call`` spans, per product."""
    return _per_product_us(spans, "spmv.call", products, dropped)


def launch_us(spans: list[dict], products: int, dropped: bool = False):
    """Host time inside ``kernel.launch`` spans, per product."""
    return _per_product_us(spans, "kernel.launch", products, dropped)


def engine_self_us(spans: list[dict], products: int, dropped: bool = False):
    """``engine.matmul`` time less its ``spmv.call`` children, per product:
    the engine's token loop, stack and cast."""
    matmuls = _named(spans, "engine.matmul")
    if dropped or not matmuls or products <= 0:
        return None
    ids = {s["id"] for s in matmuls}
    children = sum(s["dur_s"] for s in _named(spans, "spmv.call") if s["parent"] in ids)
    return (sum(s["dur_s"] for s in matmuls) - children) / products * 1e6


def _device_calls(spans: list[dict]) -> list[tuple[int, int]]:
    """The served calls' device intervals (event to event), in order."""
    return sorted((s["dev_start_ns"], s["dev_end_ns"]) for s in _named(spans, "spmv.call")
                  if "dev_start_ns" in s)


def _gaps(calls: list[tuple[int, int]]) -> list[tuple[int, int]]:
    return [(a1, b0) for (_, a1), (b0, _) in zip(calls, calls[1:]) if b0 > a1]


def device_gap_us(spans: list[dict], products: int, dropped: bool = False):
    """Device time between one served call's end event and the next one's
    start event, summed over the stretch, per product."""
    calls = _device_calls(spans)
    if dropped or len(calls) < 2 or products <= 0:
        return None
    return sum(g1 - g0 for g0, g1 in _gaps(calls)) / products / 1e3


def served_bytes_ratio(spans: list[dict], products: int, needed_per_product: float,
                       dropped: bool = False):
    """Bytes the served calls' containers, ``x`` and ``y`` come to, per
    product, over the bytes a product needs (the benchmark's yardstick)."""
    calls = [s for s in _named(spans, "spmv.call") if "bytes" in s.get("attrs", {})]
    if dropped or not calls or products <= 0 or needed_per_product <= 0:
        return None
    return sum(s["attrs"]["bytes"] for s in calls) / products / needed_per_product


def tuner_dataset_s(setup_spans: list[dict], dropped: bool = False):
    """Seconds of set-up inside ``tuner.dataset``."""
    hits = _named(setup_spans, "tuner.dataset")
    if dropped or not hits:
        return None
    return sum(s["dur_s"] for s in hits)


def idle_gaps_by_span(spans: list[dict], dropped: bool = False, top: int = 10):
    """Device gaps between consecutive served calls, in seconds, by the
    innermost span open on the host at each gap's middle (``caller`` where
    none is): ``[[label, seconds]]``, the ``top`` largest."""
    calls = _device_calls(spans)
    if dropped or len(calls) < 2:
        return None
    host = [(s["end_ns"] - s["start_ns"], s["start_ns"], s["end_ns"], s["name"]) for s in spans]
    by_label: dict[str, int] = defaultdict(int)
    for g0, g1 in _gaps(calls):
        mid = (g0 + g1) // 2
        open_ = [(d, n) for d, s, e, n in host if s <= mid < e]
        by_label[min(open_)[1] if open_ else "caller"] += g1 - g0
    ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return [[label, ns / 1e9] for label, ns in ranked]


def stretch(system, mix: dict, steps: int) -> float:
    """``steps`` calls in the cell's client cadence (a wait every
    ``sync_every`` calls, or each answer back on the host), ending with a
    wait; returns the host seconds spent inside the program's calls."""
    from bench.harness.window import sync

    pool, step, device = system.pool, system.step, system.device
    every = int(mix.get("sync_every", 0))
    inside = 0.0
    for i in range(steps):
        a = time.perf_counter()
        outs = step(pool[i % len(pool)])
        inside += time.perf_counter() - a
        if mix["client"] == "requests":
            tuple(o.cpu() for o in outs)
        elif (i + 1) % every == 0:
            sync(device)
    sync(device)
    return inside


def run(cell_name: str, seed: int, turns: int, steps: int | None) -> dict:
    """The reading of one cell on the first card."""
    import torch

    from bench.harness.catalog import Catalog
    from bench.harness.window import sync
    from repro_torch.obs.trace import tracing

    catalog = Catalog.load()
    cell = catalog.cell(cell_name)
    cfg, mix = catalog.config(cell), catalog.traffic(cell)
    client = catalog.module("clients", mix["client"])
    device = torch.device("cuda", 0)
    system = catalog.module("systems", cfg["system"]).System(cfg, mix, seed, device)
    torch.empty(0, device=device)
    system.inputs()
    with tracing() as tracer:
        tracer.clear()
        t = time.perf_counter()
        system.build_tuner()
        tuner_build_s = time.perf_counter() - t
        t = time.perf_counter()
        system.first_answer()
        sync(device)
        first_answer_s = time.perf_counter() - t
        setup_spans = tracer.spans()
        setup_dropped = bool(tracer.drops)
    client.warm(system, mix)
    prof = client.profile(system, mix)
    steps = int(steps or mix["profile_steps"])
    products = steps * system.products_per_step
    host_us = {"off": [], "on": []}
    for _ in range(turns):
        for on in (False, True, True, False):
            with tracing(on) as tracer:
                tracer.clear()
                inside = stretch(system, mix, steps)
                if on:  # the last traced stretch is read
                    spans, drops, device_drops = tracer.spans(), tracer.drops, tracer.device_drops
            host_us["on" if on else "off"].append(inside / products * 1e6)
    dropped = bool(drops or device_drops)
    needed = system.work[0] / system.products_per_step
    counts: dict[str, int] = defaultdict(int)
    for s in spans:
        counts[s["name"]] += 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    return {
        "cell": cell_name, "seed": seed, "card": card, "torch": torch.__version__,
        "steps": steps, "products": products, "turns": turns,
        "setup": {"tuner_build_s": tuner_build_s, "first_answer_s": first_answer_s,
                  "tuner_dataset_s": tuner_dataset_s(setup_spans, setup_dropped),
                  "spans": {n: sum(s["dur_s"] for s in _named(setup_spans, n))
                            for n in ("tuner.build", "tuner.dataset", "tuner.fit",
                                      "tuner.overhead", "session.analyze",
                                      "matrix.fingerprint", "features.extract",
                                      "engine.register", "kernel.compile")}},
        "device_idle_share": (1 - prof.busy_s / prof.window_s) * 100,
        "host_us_per_product": host_us,
        "served_call_us": served_call_us(spans, products, dropped),
        "launch_us": launch_us(spans, products, dropped),
        "engine_self_us": engine_self_us(spans, products, dropped),
        "device_gap_us": device_gap_us(spans, products, dropped),
        "served_bytes_ratio": served_bytes_ratio(spans, products, needed, dropped),
        "idle_gaps_by_span": idle_gaps_by_span(spans, dropped),
        "drops": drops, "device_drops": device_drops, "span_counts": dict(counts),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/trace_stretch.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--steps", type=int, default=None,
                    help="calls a stretch (default: the traffic's profile_steps)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    out = run(args.workload, args.seed, args.turns, args.steps)
    line = json.dumps(out)
    dest = ROOT / "build" / f"trace_stretch_{args.workload}_{args.seed}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
