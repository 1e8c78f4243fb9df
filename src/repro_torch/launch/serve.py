"""Serving launcher: ``python -m repro_torch.launch.serve --spmv
[--spmv-cache tuning.json] [--device cuda|cpu] [--partition [--max-blocks K]
[--fused]] [--format-plugins repro_torch.sparse.bcsr]``.

Runs the multi-matrix Auto-SpMV pipeline: synthetic traffic drawn from the
paper's matrix suite (with repeats, as real solver fleets resubmit the same
systems) flows through an ``AutoSpmvSession``-backed ``SpmvServer`` whose
kernels run on ``--device`` (default ``cuda``; the launcher raises when the
card is absent rather than serving from the CPU). With ``--spmv-cache`` the
tuning decisions persist to JSON, so a relaunched server starts warm and
skips the predictor inferences. ``--partition`` serves per-matrix
composite plans over nnz-balanced row blocks (``--fused``: one launch per
request); ``--format-plugins`` imports modules that register extra formats.

The reference launcher's LM mode and its telemetry, SLO, anomaly and fleet
flags belong to later slices of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.session import AutoSpmvSession, build_tuner
from repro_torch.kernels.common import resolve_device
from repro_torch.sparse.generate import MATRIX_NAMES, generate_by_name
from repro_torch.sparse.registry import default_format, format_names
from repro_torch.train.serve import SpmvRequest, SpmvServer
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def serve_spmv(args) -> list[SpmvRequest]:
    if args.format_plugins:
        # plugin modules register extra sparse formats on import; they then
        # flow through the tuning space and serving untouched
        import importlib

        for mod in args.format_plugins.split(","):
            importlib.import_module(mod.strip())
        log.info("format registry after plugins: %s", format_names())

    device = resolve_device(args.device)
    t0 = time.time()
    tuner = build_tuner(
        scale=args.spmv_scale,
        names=MATRIX_NAMES[: args.spmv_train_matrices],
        device=device,
    )
    log.info("tuner ready in %.1fs (device %s)", time.time() - t0, device)

    session = AutoSpmvSession(tuner, cache_path=args.spmv_cache)
    if len(session.cache):
        log.info("warm start: %d cached plans from %s", len(session.cache), args.spmv_cache)
    server = SpmvServer(
        session, partition=args.partition, max_blocks=args.max_blocks, fused=args.fused
    )
    if args.partition:
        log.info(
            "partitioned serving: composite plans up to %d nnz-balanced row "
            "blocks per matrix (monolithic fallback when partitioning loses)%s",
            args.max_blocks,
            ", fused single-launch executor" if args.fused else "",
        )

    # synthetic traffic: suite matrices with repeats (fleet-like resubmission)
    rng = np.random.default_rng(args.seed)
    pool = MATRIX_NAMES[: max(args.requests // 4, 2)]
    reqs = []
    for i in range(args.requests):
        dense = generate_by_name(str(rng.choice(pool)), scale=args.spmv_scale)
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        reqs.append(SpmvRequest(rid=i, dense=dense, x=x, objective=args.objective))
    done = server.run(reqs)

    for r in done:
        ref = r.dense @ r.x
        err = np.abs(r.y - ref).max() / (np.abs(ref).max() + 1e-9)
        log.info(
            "req %d: hit=%s fmt=%s%s rel.err=%.2e %s",
            r.rid,
            r.cache_hit,
            r.fmt or default_format(),
            " (explore)" if r.exploratory else "",
            err,
            r.schedule,
        )
    stats = session.stats
    log.info(
        "served %d requests with %d feature passes, %d plans, %d kernel compiles; cache %s",
        len(done),
        stats.feature_extractions,
        stats.plans_computed,
        stats.kernel_compiles,
        session.cache.stats(),
    )
    log.info("server summary: %s", server.summary())
    if args.spmv_cache:
        session.save()
        log.info("tuning cache saved to %s", args.spmv_cache)
    if args.metrics_export:
        from repro_torch.obs import get_metrics

        get_metrics().write_shard(args.metrics_export, args.obs_instance)
        log.info("metrics shard -> %s", args.metrics_export)
    if args.trace_export:
        from repro_torch.obs import get_tracer

        n = get_tracer().export_jsonl(args.trace_export)
        log.info("trace shard -> %s (%d spans)", args.trace_export, n)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spmv", action="store_true",
                    help="serve SpMV traffic through an AutoSpmvSession")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: 'cuda' (default; raises when "
                         "no card is present) or 'cpu' (plain PyTorch versions)")
    ap.add_argument("--spmv-cache", default=None,
                    help="JSON path for the persistent tuning cache")
    ap.add_argument("--spmv-scale", type=float, default=0.0015)
    ap.add_argument("--spmv-train-matrices", type=int, default=8)
    ap.add_argument("--format-plugins", default=None,
                    help="comma-separated modules registering extra sparse "
                         "formats (e.g. repro_torch.sparse.bcsr)")
    ap.add_argument("--partition", action="store_true",
                    help="partitioned SpMV serving: per-matrix composite "
                         "plans over nnz-balanced row blocks, each block "
                         "with its own format/schedule")
    ap.add_argument("--max-blocks", type=int, default=8,
                    help="block-count budget for --partition (searched over "
                         "{1, 2, 4, 8} up to this bound; 1 = monolithic)")
    ap.add_argument("--fused", action="store_true",
                    help="with --partition: run the composite plan as ONE "
                         "launch of the fused kernel instead of per-block "
                         "kernels")
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy", "power", "efficiency"])
    ap.add_argument("--metrics-export", default=None,
                    help="write the metrics registry as a JSONL shard here "
                         "after serving")
    ap.add_argument("--trace-export", default=None,
                    help="append the collected spans as a JSONL shard here "
                         "after serving")
    ap.add_argument("--obs-instance", default="serve",
                    help="instance label stamped into exported shards")
    args = ap.parse_args(argv)

    if not args.spmv:
        ap.error("--spmv is required: the LM serving mode is not ported yet")
    return serve_spmv(args)


if __name__ == "__main__":
    main()
