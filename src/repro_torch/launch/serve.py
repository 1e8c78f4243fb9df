"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--lm-sparse] [--device cuda|cpu]`` (LM mode) or ``python -m
repro_torch.launch.serve --spmv [--spmv-cache tuning.json] [--device
cuda|cpu] [--partition [--max-blocks K] [--fused]] [--format-plugins
repro_torch.sparse.bcsr]`` (SpMV mode). Kernels run on ``--device``
(default ``cuda``; the launcher raises when the card is absent rather than
serving from the CPU).

LM mode runs the slot-batched ``BatchedServer`` on synthetic requests with
the architecture's reduced config, as the reference launcher does (full
width is driven through the public functions, e.g. by ``chip_smoke.py``).
With ``--lm-sparse`` every FFN weight (for a MoE config: every expert's
slices and the shared experts too) is magnitude-pruned to ``--lm-density``
and registered with a ``SparseInferenceEngine``: each decode token then goes
through session-planned SpMV kernels (the CSR kernel of compile-time mode).
A MoE config is then served with ``dispatch_format="dense"``, as the
reference does: the engine runs every expert on every token, weighted by
the gate. ``--slo`` stamps an SLO class on every request
(``mixed`` cycles all four); ``--summary-export`` writes the server summary
as JSON.

SpMV mode runs the multi-matrix Auto-SpMV pipeline: synthetic traffic drawn
from the paper's matrix suite (with repeats, as real solver fleets resubmit
the same systems) flows through an ``AutoSpmvSession``-backed
``SpmvServer``. With ``--spmv-cache`` the tuning decisions persist to JSON,
so a relaunched server starts warm and skips the predictor inferences.
``--partition`` serves per-matrix composite plans over nnz-balanced row
blocks (``--fused``: one launch per request); ``--format-plugins`` imports
modules that register extra formats.

Telemetry flags (SpMV mode): ``--telemetry`` times every served kernel and
aggregates per-(bucket, format) measurement arms; ``--telemetry-log`` makes
the records a restart-surviving JSONL append-log (the bandit warm-starts
from it); ``--adaptive`` layers the UCB bandit + drift detector on top
(implies ``--telemetry``), also per row block with ``--partition``;
``--refit-every`` refits the format classifier from telemetry;
``--calibrate-every`` refits the cost model's per-format corrections and
saves them beside ``--spmv-cache``.

Active-observability flags: ``--slo-config`` attaches an ``SloTracker``
(burn-rate alerting + objective escalation; JSON overrides the per-class
targets) in both modes — in SpMV mode requests get SLO classes via
``--spmv-slo``; ``--anomaly`` runs the cost-model residual watchdog
(recalibrate + targeted eviction on sustained anomaly); ``--fleet-dir`` +
``--sync-every`` sync the bandit posterior with peer serve processes
through a shared shard directory (``obs/sync.py``), with a final sync at
shutdown; ``--metrics-port`` serves ``/metrics`` and ``/slo`` while the
run lasts; ``--profile-dir`` records the serving run with
``torch.profiler``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.session import AutoSpmvSession, build_tuner
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params, model_specs
from repro_torch.obs.trace import tracing
from repro_torch.sparse.generate import MATRIX_NAMES, generate_by_name
from repro_torch.sparse.registry import default_format, format_names
from repro_torch.train.serve import (
    BatchedServer,
    Request,
    ServeConfig,
    SpmvRequest,
    SpmvServer,
)
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def _build_lm_engine(args, cfg, params, device):
    """Stand up the sparse serving stack: a cheap tuner + shared session +
    one ``SparseInferenceEngine`` holding the magnitude-pruned FFN weights.
    Returns (engine, pruned params)."""
    from repro_torch.models.sparse_linear import SparseInferenceEngine, prune_model_ffns

    t0 = time.time()
    tuner = build_tuner(
        scale=0.0008, names=MATRIX_NAMES[:4], n_extra=0, fit_overhead=False, device=device
    )
    log.info("lm-sparse tuner ready in %.1fs", time.time() - t0)
    log.info("tuner labelled by %s", tuner.dataset.meta["model"])
    session = AutoSpmvSession(tuner)
    engine = SparseInferenceEngine(session)
    pruned = prune_model_ffns(params, cfg, engine, density=args.lm_density)
    log.info(
        "lm-sparse: %d FFN matrices registered (%d SpMV-eligible) at density %.3f",
        engine.stats.registered, engine.stats.spmv_layers, args.lm_density,
    )
    return engine, pruned


def serve_lm(args) -> list[Request]:
    from repro_torch.models.sparse_linear import SLO_PRIORITY

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced_config=True)
    if cfg.prefix_len:
        cfg = cfg.replace(prefix_len=0, prefix_lm=False)  # text-only serving demo
    engine = None
    if args.lm_sparse and cfg.n_experts and cfg.dispatch_format != "dense":
        # the engine's gate-masked per-expert path mirrors the dense
        # dispatch exactly; ell/sell drop capacity-overflow tokens
        cfg = cfg.replace(dispatch_format="dense")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_specs(cfg), gen, cfg.param_dtype, device=device)
    if args.lm_sparse:
        engine, params = _build_lm_engine(args, cfg, params, device)
    slo_tracker = None
    if args.slo_config:
        from repro_torch.obs.slo import SloConfig, SloTracker

        slo_tracker = SloTracker(SloConfig.load(args.slo_config))
    server = BatchedServer(
        params, cfg,
        ServeConfig(batch_slots=args.slots, max_len=args.max_len,
                    max_new_tokens=args.max_new_tokens),
        engine=engine,
        slo=slo_tracker,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 17))).tolist(),
            max_new_tokens=args.max_new_tokens,
            slo=SLO_PRIORITY[i % len(SLO_PRIORITY)] if args.slo == "mixed" else args.slo,
        )
        for i in range(args.requests)
    ]
    done = server.run(reqs)
    for r in done:
        log.info("req %d [%s]: prompt %d toks -> %s", r.rid, r.slo, len(r.prompt), r.generated)
    tput = sum(len(r.generated) for r in done) / max(done[0].latency_s, 1e-9)
    log.info("aggregate throughput: %.1f tok/s over %d requests", tput, len(done))
    summary = server.summary()
    log.info("server summary: %s", summary)
    if args.summary_export:
        import json

        from repro_torch.utils.io import atomic_write_text

        atomic_write_text(
            args.summary_export, json.dumps(summary, indent=1, default=float)
        )
        log.info("summary -> %s", args.summary_export)
    return done


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
    log.info("tuner labelled by %s", tuner.dataset.meta["model"])

    # active-observability features imply their substrates: fleet sync needs
    # the bandit posterior, the anomaly watchdog needs calibration pairs
    want_adaptive = args.adaptive or args.fleet_dir is not None
    telemetry = adaptive = feedback = None
    if (
        args.telemetry
        or want_adaptive
        or args.telemetry_log
        or args.refit_every > 0
        or args.calibrate_every > 0
        or args.anomaly
    ):
        from repro_torch.telemetry import (
            AdaptiveFormatSelector,
            FeedbackConfig,
            FeedbackLoop,
            TelemetryRecorder,
        )

        telemetry = TelemetryRecorder(log_path=args.telemetry_log)
        if telemetry.total_observations():
            log.info(
                "telemetry warm start: %s from %s",
                telemetry.summary(),
                args.telemetry_log,
            )
        if want_adaptive:
            adaptive = AdaptiveFormatSelector()
            seeded = adaptive.warm_start(telemetry)
            if seeded:
                log.info("bandit warm start: %d arms seeded from the log", seeded)
        if args.refit_every > 0:
            # base_dataset keeps the offline labels in every refit: a few
            # fleet measurements sharpen the classifier, never replace its
            # coverage of unmeasured feature regions
            feedback = FeedbackLoop(
                telemetry,
                base_dataset=tuner.dataset,
                config=FeedbackConfig(refit_every=args.refit_every),
            )

    session = AutoSpmvSession(
        tuner, cache_path=args.spmv_cache, telemetry=telemetry, adaptive=adaptive
    )
    if len(session.cache):
        log.info("warm start: %d cached plans from %s", len(session.cache), args.spmv_cache)

    spmv_slo = args.spmv_slo or ("mixed" if args.slo_config else None)
    slo_tracker = None
    if spmv_slo:
        from repro_torch.obs.slo import SLO_CLASSES, SloConfig, SloTracker

        slo_cfg = SloConfig.load(args.slo_config) if args.slo_config else SloConfig()
        slo_tracker = SloTracker(slo_cfg)
        log.info(
            "slo tracking on %d class(es), windows %d/%d",
            len(slo_cfg.targets), slo_cfg.fast_window, slo_cfg.slow_window,
        )
    fleet = None
    if args.fleet_dir is not None:
        from repro_torch.obs.sync import FleetSync

        fleet = FleetSync(
            session,
            args.fleet_dir,
            instance=args.obs_instance,
            sync_every=args.sync_every,
        )
        log.info(
            "fleet sync [%s]: shard %s, every %d request(s)",
            args.obs_instance, fleet.shard_path, args.sync_every,
        )
    server = SpmvServer(
        session,
        feedback=feedback,
        partition=args.partition,
        max_blocks=args.max_blocks,
        fused=args.fused,
        calibrate_every=args.calibrate_every,
        slo=slo_tracker,
        anomaly=args.anomaly,
        fleet=fleet,
    )
    if args.metrics_port is not None:
        server.start_metrics_server(args.metrics_port)
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
        slo = None
        if spmv_slo is not None:
            slo = SLO_CLASSES[i % len(SLO_CLASSES)] if spmv_slo == "mixed" else spmv_slo
        reqs.append(
            SpmvRequest(rid=i, dense=dense, x=x, objective=args.objective, slo=slo)
        )
    try:
        if args.profile_dir:
            from repro_torch.obs import profile_capture

            with profile_capture(args.profile_dir):
                done = server.run(reqs)
        else:
            done = server.run(reqs)
    finally:
        if args.metrics_port is not None:
            server.stop_metrics_server()

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
    if telemetry is not None:
        telemetry.flush()
        if args.telemetry_log:
            log.info("telemetry log flushed to %s", args.telemetry_log)
    if fleet is not None:
        # shutdown flush: export the final local posterior and absorb
        # whatever the peers wrote since the last periodic sync
        log.info("final fleet sync: %s", fleet.sync())
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
    ap.add_argument("--arch", default=None, choices=sorted(ARCH_IDS),
                    help="LM mode: model architecture to serve (reduced config)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-sparse", action="store_true",
                    help="LM mode: magnitude-prune the FFN weights and route "
                         "their matmuls through session-planned SpMV kernels "
                         "(models/sparse_linear.py)")
    ap.add_argument("--lm-density", type=float, default=0.05,
                    help="with --lm-sparse: kept-weight fraction per FFN matrix")
    ap.add_argument("--slo", default="latency-critical",
                    choices=["latency-critical", "power-capped", "balanced",
                             "energy-saving", "mixed"],
                    help="LM mode: the SLO class stamped on every request "
                         "('mixed' cycles all four across the request stream)")
    ap.add_argument("--summary-export", default=None,
                    help="LM mode: write the server summary (SLO mix, engine "
                         "plans, energy cells) as JSON here")
    ap.add_argument("--spmv", action="store_true",
                    help="serve SpMV traffic through an AutoSpmvSession")
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
                         "kernels; disables per-block bandit timing")
    ap.add_argument("--calibrate-every", type=int, default=0,
                    help="refit the CalibratedCostModel from telemetry every "
                         "N served requests (0=off; needs --telemetry); the "
                         "fit persists next to --spmv-cache")
    ap.add_argument("--telemetry", action="store_true",
                    help="measure every served kernel and aggregate per-arm stats")
    ap.add_argument("--telemetry-log", default=None,
                    help="JSONL append-log path; replayed on restart "
                         "(implies --telemetry)")
    ap.add_argument("--adaptive", action="store_true",
                    help="UCB format bandit + drift-triggered cache invalidation "
                         "(implies --telemetry)")
    ap.add_argument("--refit-every", type=int, default=0,
                    help="refit the format classifier every N observations "
                         "(0=off; implies --telemetry)")
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy", "power", "efficiency"])
    ap.add_argument("--metrics-export", default=None,
                    help="write the metrics registry as a JSONL shard here "
                         "after serving")
    ap.add_argument("--trace-export", default=None,
                    help="SpMV mode: trace the run (the tracer is off "
                         "otherwise) and append its spans as a JSONL shard "
                         "here after serving")
    ap.add_argument("--obs-instance", default="serve",
                    help="instance label stamped into exported shards")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="SpMV mode: serve Prometheus /metrics (+ /healthz, "
                         "/obs, /slo) on 127.0.0.1 at this port from a daemon "
                         "thread while serving (0 = ephemeral)")
    ap.add_argument("--slo-config", default=None,
                    help="JSON overriding the per-class SLO targets; attaches "
                         "burn-rate alerting + objective escalation "
                         "(obs/slo.py) in either mode")
    ap.add_argument("--spmv-slo", default=None,
                    choices=["latency-critical", "power-capped", "balanced",
                             "energy-saving", "mixed"],
                    help="SpMV mode: SLO class stamped on requests ('mixed' "
                         "cycles all four); defaults to 'mixed' when "
                         "--slo-config is given")
    ap.add_argument("--anomaly", action="store_true",
                    help="SpMV mode: cost-model residual watchdog — on "
                         "sustained anomaly, drop the format's calibration "
                         "window, recalibrate, and evict its cached plans "
                         "(implies --telemetry)")
    ap.add_argument("--fleet-dir", default=None,
                    help="SpMV mode: shared directory of fleet shards; the "
                         "bandit posterior syncs with peer serve processes "
                         "through it (implies --adaptive)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="with --fleet-dir: sync after every N served "
                         "requests (plus a final sync at shutdown)")
    ap.add_argument("--profile-dir", default=None,
                    help="SpMV mode: record the serving run with "
                         "torch.profiler into this directory (Chrome trace)")
    args = ap.parse_args(argv)

    if args.spmv:
        with tracing(bool(args.trace_export)):  # the spans the run exports
            return serve_spmv(args)
    if args.arch is None:
        ap.error("--arch is required unless --spmv is given")
    return serve_lm(args)


if __name__ == "__main__":
    main()
