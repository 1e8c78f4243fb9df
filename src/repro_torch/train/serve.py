"""Batched serving: the multi-matrix SpMV pipeline.

``SpmvServer``: the Auto-SpMV serving pipeline. Every request carries a
matrix + vector; instead of compiling a kernel inline per request, the
server consults a shared ``AutoSpmvSession`` — batches are deduplicated by
matrix fingerprint, plans come from the feature-bucketed cache (persisted
across restarts), and prepared kernels are reused from the process memo. The
tuning cost is thereby paid once per unique matrix per fleet, which is the
paper's §5.3 amortization argument turned into a serving layer.

With telemetry attached to the session (duck-typed recorder / adaptive
selector) the server times every kernel execution and feeds it back via
``session.observe``.

With ``partition=True`` every request gets a per-matrix composite plan
over nnz-balanced row blocks (``session.partitioned_optimize``), run block
by block or, with ``fused=True``, as one launch of the fused kernel.

Kernels run on the session tuner's device; each request's ``y`` comes back
to the host as a numpy array, which also synchronises the launch, so the
measured execution time covers the kernel and the copy.

Not in this slice: partitioned serving on the observed (telemetry/adaptive)
path, SLO tracking, the anomaly watchdog, fleet sync, periodic calibration
and the metrics HTTP endpoint — asking for one raises
``NotImplementedError``. The LM ``BatchedServer`` is a later slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.core.session import AutoSpmvSession
from repro_torch.obs.energy import EnergyAccountant
from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.trace import get_tracer, span as _span
from repro_torch.sparse.registry import default_format
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


@dataclass
class SpmvRequest:
    """One SpMV serving request: y = A @ x, tuned for ``objective``."""

    rid: int
    dense: np.ndarray
    x: np.ndarray
    objective: str = "latency"
    slo: str | None = None  # SLO class; resolving one needs the SLO slice
    # outputs
    y: np.ndarray | None = None
    schedule: Any = None  # KernelSchedule the session picked
    fmt: str | None = None  # format served (telemetry/adaptive path)
    cache_hit: bool = False  # plan came from the session cache
    exploratory: bool = False  # served off-incumbent by the bandit
    latency_s: float = 0.0
    served_objective: str | None = None  # what the request actually ran under


def _to_host(y) -> np.ndarray:
    """Result vector as numpy; for a CUDA tensor the copy waits for the kernel."""
    return y.detach().cpu().numpy()


class SpmvServer:
    """Batched multi-matrix SpMV serving on top of an ``AutoSpmvSession``.

    ``run`` takes one batch of requests, groups them by objective, asks the
    session to tune each group via ``optimize_many`` (fingerprint dedup +
    plan cache + kernel memo), then executes every request with its shared
    prepared kernel. The server never compiles inline — all tuning economics
    live in the session, so a restart with a warm ``cache_path`` skips the
    predictor inferences entirely.
    """

    def __init__(
        self,
        session: AutoSpmvSession,
        *,
        adaptive: bool | None = None,
        feedback=None,  # optional feedback loop (duck-typed: maybe_refit/refits)
        partition: bool = False,
        max_blocks: int = 8,
        fused: bool = False,
        calibrate_every: int = 0,
        slo=None,
        anomaly: bool = False,
        fleet=None,
    ):
        later = {
            "calibrate_every": calibrate_every,
            "slo": slo is not None,
            "anomaly": anomaly,
            "fleet": fleet is not None,
        }
        asked = [name for name, on in later.items() if on]
        if asked:
            raise NotImplementedError(
                f"SpmvServer({', '.join(asked)}=...) belongs to a later slice of "
                "the port (see ROADMAP.md); the reference package serves it"
            )
        self.session = session
        # default: take the observed path whenever the session can consume
        # measurements (telemetry recorder and/or bandit attached)
        self.adaptive = (
            adaptive
            if adaptive is not None
            else (session.telemetry is not None or session.adaptive is not None)
        )
        if partition and self.adaptive:
            raise NotImplementedError(
                "partitioned serving on the observed (telemetry/adaptive) path "
                "needs per-block arms from the telemetry slice of the port"
            )
        self.feedback = feedback
        self.partition = partition
        self.max_blocks = max_blocks
        # single-launch composite executor on the partitioned path
        self.fused = fused
        self.batches_served = 0
        self.requests_served = 0
        # observability: request counters + latency histograms live in the
        # process metrics registry; modeled-energy accounting per cell
        self.metrics = get_metrics()
        self.energy = EnergyAccountant(self.metrics)

    def _resolve_objective(self, req: SpmvRequest) -> str:
        if req.slo is not None:
            raise NotImplementedError(
                "SLO-classed requests need the SLO slice of the port; "
                "set SpmvRequest.objective instead"
            )
        return req.objective

    def _account(
        self,
        objective: str,
        fmt: str,
        measured_s: float,
        modeled: dict | None,
        *,
        block: str = "",
    ) -> None:
        """Fold one served execution into counters/histograms/energy cells."""
        self.metrics.counter("spmv_requests_total", fmt=fmt, objective=objective).inc()
        self.metrics.histogram(
            "spmv_request_latency_seconds", objective=objective
        ).observe(measured_s)
        self.energy.observe(
            fmt=fmt,
            objective=objective,
            measured_s=measured_s,
            modeled=modeled,
            block=block,
        )

    def _run_observed(self, objective: str, group: list[SpmvRequest]) -> None:
        """Per-request serve + measure + observe (telemetry/adaptive mode).

        Requests are timed individually — the measurement *is* the product
        here, so the batch dedup of ``optimize_many`` gives way to per-call
        timing; plan/kernel reuse still comes from the session caches."""
        for req in group:
            with _span("server.request", rid=req.rid, objective=objective, mode="observed"):
                plan = self.session.serve_optimize(req.dense, objective)
                with _span("kernel.execute", fmt=plan.fmt):
                    t0 = time.perf_counter()
                    y = _to_host(plan.kernel(req.x))
                    dt = time.perf_counter() - t0
                req.y = y
                req.schedule = plan.schedule
                req.fmt = plan.fmt
                req.cache_hit = plan.cache_hit
                req.exploratory = plan.exploratory
                req.latency_s = dt
                self.session.observe(plan, dt)
                self._account(objective, plan.fmt, dt, plan.predicted)
        self._maybe_refit()

    def _maybe_refit(self) -> None:
        if self.feedback is not None:
            refit = self.feedback.maybe_refit(self.session.tuner.predictor)
            if refit:
                log.info("telemetry refit after batch: %s", refit)

    def _run_partitioned(self, objective: str, group: list[SpmvRequest]) -> None:
        """Per-request partitioned serve: the composite kernel runs as one
        call (no per-block synchronise is paid for measurements nothing
        would consume); its time covers the kernel(s) and the copy of ``y``."""
        for req in group:
            with _span(
                "server.request", rid=req.rid, objective=objective, mode="partitioned"
            ):
                res = self.session.partitioned_optimize(
                    req.dense, objective, max_blocks=self.max_blocks, fused=self.fused
                )
                t0 = time.perf_counter()
                y = _to_host(res.kernel(req.x))
                dt = time.perf_counter() - t0
                req.y = y
                req.schedule = res.plan.blocks[0].schedule
                req.fmt = "+".join(res.formats)
                req.cache_hit = res.cache_hit
                req.latency_s = dt
                self._account(objective, req.fmt, dt, res.plan.modeled.as_dict())
        self._maybe_refit()

    def run(self, requests: list[SpmvRequest]) -> list[SpmvRequest]:
        by_objective: dict[str, list[SpmvRequest]] = {}
        for r in requests:
            r.served_objective = self._resolve_objective(r)
            by_objective.setdefault(r.served_objective, []).append(r)
        for objective, group in by_objective.items():
            if self.partition:
                self._run_partitioned(objective, group)
                continue
            if self.adaptive:
                self._run_observed(objective, group)
                continue
            t_group = time.perf_counter()
            seen_keys = {
                (e.bucket, e.objective, e.mode) for e in self.session.cache.entries()
            }
            results = self.session.optimize_many(
                [r.dense for r in group], objective, mode="compile"
            )
            for req, res in zip(group, results):
                with _span(
                    "server.request", rid=req.rid, objective=objective, mode="batch"
                ):
                    req.schedule = res.schedule
                    with _span("kernel.execute", fmt=default_format()):
                        t_exec = time.perf_counter()
                        req.y = _to_host(res.kernel(req.x))
                        exec_s = time.perf_counter() - t_exec
                    # a request is a hit if its plan existed before the batch
                    # OR was produced for an earlier request in this batch
                    key = self.session.plan_key(res.features, objective)
                    req.cache_hit = key in seen_keys
                    seen_keys.add(key)
                    self._account(objective, default_format(), exec_s, res.predicted)
            # latency covers this group's tuning + execution only, not other
            # objective groups tuned later in the same batch
            dt = time.perf_counter() - t_group
            for req in group:
                req.latency_s = dt
        self.batches_served += 1
        self.requests_served += len(requests)
        log.info(
            "spmv batch: %d requests, %d unique kernels compiled so far, %s",
            len(requests),
            self.session.stats.kernel_compiles,
            self.session.cache.stats(),
        )
        return requests

    def summary(self) -> dict:
        """Server-level stats incl. telemetry/bandit state (serve CLI dump)."""
        out = {
            "batches": self.batches_served,
            "requests": self.requests_served,
            "session": self.session.stats.as_dict(),
            "cache": self.session.cache.stats(),
        }
        if self.session.telemetry is not None:
            out["telemetry"] = self.session.telemetry.summary()
        if self.session.adaptive is not None:
            out["adaptive"] = self.session.adaptive.summary()
        if self.feedback is not None:
            out["refits"] = self.feedback.refits
        latency: dict[str, dict] = {}
        for hist in self.metrics.instruments("histogram", "spmv_request_latency_seconds"):
            if not hist.count:
                continue
            labels = dict(hist.labels)
            latency[labels.get("objective", "")] = hist.as_dict()
        if latency:
            out["latency"] = latency
        energy = self.energy.per_format()
        if energy:
            out["energy"] = {f: c.as_dict() for f, c in sorted(energy.items())}
        return out

    # --------------------------------------------------------- observability
    def dump_obs(
        self, out_dir, *, instance: str = "server"
    ) -> dict[str, str]:
        """Export this instance's observability shards: a metrics JSONL
        shard, a trace JSONL shard, and the summary (with energy/latency
        aggregates) as JSON. Returns path strings."""
        import json
        from pathlib import Path

        from repro_torch.utils.io import atomic_write_text

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        metrics_path = out_dir / f"metrics-{instance}.jsonl"
        trace_path = out_dir / f"trace-{instance}.jsonl"
        summary_path = out_dir / f"summary-{instance}.json"
        self.metrics.write_shard(metrics_path, instance)
        get_tracer().export_jsonl(trace_path)
        atomic_write_text(
            summary_path, json.dumps(self.summary(), indent=1, default=float)
        )
        log.info("observability shards -> %s", out_dir)
        return {
            "metrics": str(metrics_path),
            "trace": str(trace_path),
            "summary": str(summary_path),
        }

    def start_metrics_server(self, port: int = 0, *, host: str = "127.0.0.1"):
        raise NotImplementedError(
            "the metrics HTTP endpoint belongs to the observability slice of the "
            "port; use dump_obs() or --metrics-export"
        )
