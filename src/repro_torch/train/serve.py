"""Batched serving: LM slot scheduler + the multi-matrix SpMV pipeline.

``BatchedServer``: fixed B decode slots; new requests are admitted by
prefilling into a free slot (per-slot surgery over the batch-leading cache
tree), and all occupied slots decode together each step. Greedy sampling.
With a ``SparseInferenceEngine`` every decode tick routes its FFN matmuls
through session-planned SpMV kernels, under the objective of the
highest-priority SLO class present (paper finding 5: the latency-optimal
configuration is not the power-optimal one).

``SpmvServer``: the Auto-SpMV serving pipeline. Every request carries a
matrix + vector; instead of compiling a kernel inline per request, the
server consults a shared ``AutoSpmvSession`` — batches are deduplicated by
matrix fingerprint, plans come from the feature-bucketed cache (persisted
across restarts), and prepared kernels are reused from the process memo. The
tuning cost is thereby paid once per unique matrix per fleet, which is the
paper's §5.3 amortization argument turned into a serving layer.

With telemetry attached to the session (repro_torch/telemetry) the server
times every kernel execution and feeds it back via ``session.observe``:
requests become labelled measurements, the bandit explores alternate formats
within budget, drifted plans are evicted, and an optional ``FeedbackLoop``
incrementally refits the format classifier from the accumulated records —
the predict→measure→relearn loop closed inside the serving path.

With ``partition=True`` every request gets a per-matrix composite plan
over nnz-balanced row blocks (``session.partitioned_optimize``), run block
by block or, with ``fused=True``, as one launch of the fused kernel. On the
observed path each block is timed on its own (``PartitionedSpmv.timed_call``)
and every (block, format) pair is its own bandit arm.

Active observability (``repro_torch.obs``): ``slo=`` (an ``SloTracker``)
feeds burn-rate windows per SLO class and escalates a firing class's
objective, in both servers; ``anomaly=True`` attaches the cost-model
residual watchdog; ``fleet=`` syncs the bandit posterior with peer
instances; ``calibrate_every=`` refits the session's cost model from
telemetry; ``start_metrics_server`` serves ``/metrics`` and ``/slo``.

Kernels run on the session tuner's device; each request's ``y`` comes back
to the host as a numpy array, which also synchronises the launch, so the
measured execution time covers the kernel and the copy (host wall time, as
in the reference package).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.session import AutoSpmvSession
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.models.sparse_linear import SLO_PRIORITY, slo_objective
from repro_torch.models.param import tree_map
from repro_torch.obs.energy import EnergyAccountant
from repro_torch.obs.http import ObsHTTPServer
from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.trace import get_tracer, span as _span
from repro_torch.sparse.registry import default_format
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import _block

log = get_logger("serve")


@dataclass
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 512
    max_new_tokens: int = 32
    objective: str = "latency"  # latency | efficiency (Auto-SpMV objective)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    slo: str = "latency-critical"  # SLO class (models/sparse_linear.py)
    generated: list[int] = field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0


class BatchedServer:
    """Slot-batched LM decode; optionally sparse-served.

    With ``engine`` (a ``SparseInferenceEngine`` over pruned FFN weights)
    every decode tick routes its FFN matmuls through planned SpMV kernels.
    Each request carries an SLO class; a shared tick runs under the
    highest-priority class among the occupied slots (``SLO_PRIORITY``), one
    decode callable per objective, while the energy accounting keys each
    request's share of the tick by its *own* class — mixed traffic shows who
    burned the joules. Prefill stays dense: the weights themselves are
    pruned, so the prompt pass is numerically identical either way.

    Everything runs on the device the params live on. With ``slo=`` (an
    ``SloTracker``) each slot's share of a tick feeds its class's burn
    windows, and a firing class escalates the tick's objective.
    """

    def __init__(
        self, params: Any, cfg: ModelConfig, sc: ServeConfig, *, engine=None,
        slo=None,  # optional repro_torch.obs.slo.SloTracker
    ):
        self.params = params
        self.cfg = cfg
        self.sc = sc
        self.engine = engine
        self.slo = slo
        self.device = params["embed"].device
        self.cache = init_cache(cfg, sc.batch_slots, sc.max_len, self.device)
        self.slot_req: list[Request | None] = [None] * sc.batch_slots
        self.slot_pos = np.zeros(sc.batch_slots, np.int32)
        self._decode = lambda p, c, t, pos: decode_step(p, cfg, c, t, pos)
        # one decode callable per objective, closing over the bound engine
        # handle (built lazily: mixed traffic may never touch some)
        self._decode_by_objective: dict[str, Any] = {}
        self.ticks = 0
        self.requests_served = 0
        self._slo_counts: dict[str, int] = {}
        self.metrics = get_metrics()
        self.energy = EnergyAccountant(self.metrics)

    # ------------------------------------------------------------ admission
    def _admit(self, req: Request, slot: int):
        tokens = torch.as_tensor(np.array(req.prompt, np.int32)[None, :], device=self.device)
        pc = init_cache(self.cfg, 1, self.sc.max_len, self.device)  # fresh, correct inits
        logits, pc, _ = prefill(self.params, self.cfg, pc, tokens=tokens)
        first = int(torch.argmax(logits[0, -1]))
        req.generated.append(first)
        # slot surgery: write the prefilled cache into slot `slot`, in place
        # (the server owns the batch cache; nothing else holds it). The batch
        # is axis 0 of head/tail leaves and axis 1 of the group-stacked ones;
        # the reference indexes axis 0 everywhere, which writes a group, not
        # a slot (ROADMAP.md queue C).
        for part, axis in (("head", 0), ("groups", 1), ("tail", 0)):
            tree_map(lambda c, p, a=axis: c.select(a, slot).copy_(p.select(a, 0)),
                     self.cache[part], pc[part])
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        if self.engine is not None:
            slo_objective(req.slo)  # validate the class at admission
            self._slo_counts[req.slo] = self._slo_counts.get(req.slo, 0) + 1
            self.metrics.counter("lm_requests_total", slo=req.slo).inc()
        log.info("admitted request %d into slot %d (prompt %d tokens)", req.rid, slot, len(req.prompt))

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    # ---------------------------------------------------------------- decode
    def _tick_objective(self) -> str:
        """The paper objective this tick decodes under: the highest-priority
        SLO class among the occupied slots wins the shared batch."""
        active = {r.slo for r in self.slot_req if r is not None}
        for slo in SLO_PRIORITY:
            if slo in active:
                if self.slo is not None:
                    # a firing class drags the shared tick to the violated
                    # dimension's objective until the burn clears
                    return self.slo.effective_objective(slo)
                return slo_objective(slo)
        return self.sc.objective

    def _decode_for(self, objective: str):
        fn = self._decode_by_objective.get(objective)
        if fn is None:
            # plan every matrix before the first tick under this objective
            self.engine.plan_all(objective)
            handle = self.engine.bind(objective)
            cfg = self.cfg
            fn = lambda p, c, t, pos: decode_step(  # noqa: E731
                p, cfg, c, t, pos, unroll_layers=True, engine=handle
            )
            self._decode_by_objective[objective] = fn
        return fn

    def _decode_tick(self):
        B = self.sc.batch_slots
        toks = np.zeros((B, 1), np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                toks[i, 0] = r.generated[-1]
        toks_t = torch.as_tensor(toks, device=self.device)
        pos = torch.as_tensor(self.slot_pos[:, None], device=self.device)
        if self.engine is None:
            t0 = time.perf_counter()
            logits, self.cache = self._decode(self.params, self.cache, toks_t, pos)
            if self.slo is not None:
                # dense decode has no per-objective engine to escalate, but
                # the burn-rate windows still need the measured latency —
                # a tracker that never sees samples can never alert
                _block(logits)
                dt = time.perf_counter() - t0
                active = [r for r in self.slot_req if r is not None]
                share = dt / max(len(active), 1)
                for r in active:
                    self.slo.observe(r.slo, latency_s=share)
                self.slo.evaluate()
        else:
            objective = self._tick_objective()
            fn = self._decode_for(objective)
            t0 = time.perf_counter()
            logits, self.cache = fn(self.params, self.cache, toks_t, pos)
            _block(logits)  # the host clock then covers the tick
            dt = time.perf_counter() - t0
            self._account_tick(objective, dt)
        self.ticks += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.generated.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if self.engine is not None:
                self.metrics.counter("lm_tokens_total", slo=r.slo).inc()
            if (
                len(r.generated) >= r.max_new_tokens
                or self.slot_pos[i] >= self.sc.max_len - 1
            ):
                r.done = True
                self.slot_req[i] = None
                self.requests_served += 1
                log.info("request %d finished (%d tokens)", r.rid, len(r.generated))

    def _account_tick(self, objective: str, dt: float) -> None:
        """Split one measured tick across the active requests' own SLO
        classes. Each slot decodes its own token through every planned
        matrix, so the modeled per-token cost is the full per-pass estimate
        while the measured wall time is shared."""
        active = [r for r in self.slot_req if r is not None]
        if not active:
            return
        self.metrics.histogram(
            "lm_decode_tick_seconds", objective=objective
        ).observe(dt)
        fmt = self.engine.format_mix(objective)
        modeled = self.engine.modeled_objectives(objective)
        share = dt / len(active)
        for r in active:
            self.energy.observe(
                fmt=fmt,
                objective=slo_objective(r.slo),
                measured_s=share,
                modeled=modeled,
                block="lm",
            )
            if self.slo is not None:
                self.slo.observe(
                    r.slo, latency_s=share, energy_j=modeled.get("energy")
                )
        if self.slo is not None:
            self.slo.evaluate()

    # ------------------------------------------------------------------- run
    def run(self, requests: list[Request]) -> list[Request]:
        pending = list(requests)
        t0 = time.perf_counter()
        while pending or any(r is not None for r in self.slot_req):
            for slot in self._free_slots():
                if not pending:
                    break
                self._admit(pending.pop(0), slot)
            if any(r is not None for r in self.slot_req):
                self._decode_tick()
        for r in requests:
            r.latency_s = time.perf_counter() - t0
        return requests

    def summary(self) -> dict:
        """Serving stats for the CLI dump / CI assertions: SLO class mix,
        engine plan counts, session amortization counters, energy cells."""
        out: dict[str, Any] = {
            "requests": self.requests_served,
            "ticks": self.ticks,
            "slo_classes": dict(sorted(self._slo_counts.items())),
        }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.engine is not None:
            out["engine"] = self.engine.summary()
            out["session"] = self.engine.session.stats.as_dict()
            cells = self.energy.summary().get("cells", {})
            if cells:
                out["energy"] = cells
            latency: dict[str, dict] = {}
            for hist in self.metrics.instruments(
                "histogram", "lm_decode_tick_seconds"
            ):
                if not hist.count:
                    continue
                labels = dict(hist.labels)
                latency[labels.get("objective", "")] = hist.as_dict()
            if latency:
                out["tick_latency"] = latency
        return out


# --------------------------------------------------------------------- SpMV
@dataclass
class SpmvRequest:
    """One SpMV serving request: y = A @ x, tuned for ``objective``."""

    rid: int
    dense: np.ndarray
    x: np.ndarray
    objective: str = "latency"
    slo: str | None = None  # SLO class; when set, the served objective is
    # resolved through the tracker (native, or escalated while firing)
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
        feedback=None,  # optional repro_torch.telemetry.FeedbackLoop
        partition: bool = False,
        max_blocks: int = 8,
        fused: bool = False,
        calibrate_every: int = 0,
        slo=None,  # optional repro_torch.obs.slo.SloTracker
        anomaly: bool = False,  # attach a CostModelWatchdog (needs telemetry)
        fleet=None,  # optional repro_torch.obs.sync.FleetSync
    ):
        self.session = session
        # default: take the observed path whenever the session can consume
        # measurements (telemetry recorder and/or bandit attached)
        self.adaptive = (
            adaptive
            if adaptive is not None
            else (session.telemetry is not None or session.adaptive is not None)
        )
        self.feedback = feedback
        self.partition = partition
        self.max_blocks = max_blocks
        # single-launch composite executor on the non-adaptive partitioned
        # path (the adaptive path needs per-block timing, which one launch
        # cannot provide)
        self.fused = fused
        # recalibrate the session's cost model every N served requests
        # (0 = never); requires telemetry on the session
        self.calibrate_every = int(calibrate_every)
        self.calibrations = 0
        self._served_since_calibration = 0
        self.batches_served = 0
        self.requests_served = 0
        # observability: request counters + latency histograms live in the
        # process metrics registry; modeled-energy accounting per cell
        self.metrics = get_metrics()
        self.energy = EnergyAccountant(self.metrics)
        self._obs_http: ObsHTTPServer | None = None
        # active observability: burn-rate alerting + escalation, cost-model
        # residual watchdog, live fleet posterior sync — all evaluated once
        # per served batch
        self.slo = slo
        self.fleet = fleet
        self.watchdog = None
        if anomaly:
            from repro_torch.obs.anomaly import CostModelWatchdog

            self.watchdog = CostModelWatchdog(session)
        self.anomaly_fires = 0

    def _resolve_objective(self, req: SpmvRequest) -> str:
        if req.slo is None:
            return req.objective
        if self.slo is not None:
            return self.slo.effective_objective(req.slo)
        return slo_objective(req.slo)

    def _account(
        self,
        objective: str,
        fmt: str,
        measured_s: float,
        modeled: dict | None,
        *,
        block: str = "",
        slo: str | None = None,
    ) -> None:
        """Fold one served execution into counters/histograms/energy cells
        (and, when the request carries an SLO class, its burn windows)."""
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
        if self.slo is not None and slo is not None:
            self.slo.observe(
                slo,
                latency_s=measured_s,
                energy_j=(modeled or {}).get("energy"),
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
                self._account(objective, plan.fmt, dt, plan.predicted, slo=req.slo)
        self._maybe_refit()

    def _maybe_refit(self) -> None:
        if self.feedback is not None:
            refit = self.feedback.maybe_refit(self.session.tuner.predictor)
            if refit:
                log.info("telemetry refit after batch: %s", refit)

    def _run_partitioned(self, objective: str, group: list[SpmvRequest]) -> None:
        """Per-request partitioned serve. On the observed path (telemetry
        and/or bandit consuming measurements) blocks are timed individually
        so each (block, format) arm learns its own wall time; otherwise the
        composite kernel runs as one call — no per-block synchronise is paid
        for measurements nothing would consume — and its time covers the
        kernel(s) and the copy of ``y``."""
        for req in group:
            with _span(
                "server.request", rid=req.rid, objective=objective, mode="partitioned"
            ):
                if self.adaptive:
                    res = self.session.serve_partitioned(
                        req.dense, objective, max_blocks=self.max_blocks
                    )
                    y, block_times = res.kernel.timed_call(req.x)
                    dt = sum(block_times)
                    self.session.observe_partitioned(res, block_times)
                    # per-block energy attribution: each row block's modeled
                    # estimate against its own measured slice
                    for bp, fmt, bt in zip(res.plan.blocks, res.formats, block_times):
                        self.energy.observe(
                            fmt=fmt,
                            objective=objective,
                            measured_s=bt,
                            modeled=bp.modeled.as_dict(),
                            block=str(bp.block.index),
                        )
                else:
                    res = self.session.partitioned_optimize(
                        req.dense, objective, max_blocks=self.max_blocks,
                        fused=self.fused,
                    )
                    t0 = time.perf_counter()
                    y = _to_host(res.kernel(req.x))
                    dt = time.perf_counter() - t0
                req.y = y
                req.schedule = res.plan.blocks[0].schedule
                req.fmt = "+".join(res.formats)
                req.cache_hit = res.cache_hit
                req.exploratory = any(res.exploratory)
                req.latency_s = dt
                self._account(
                    objective, req.fmt, dt, res.plan.modeled.as_dict(), slo=req.slo
                )
        self._maybe_refit()

    def run(self, requests: list[SpmvRequest]) -> list[SpmvRequest]:
        by_objective: dict[str, list[SpmvRequest]] = {}
        for r in requests:
            # SLO-classed requests resolve through the tracker: the class's
            # native objective, or the violated dimension's while firing
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
                    self._account(
                        objective, default_format(), exec_s, res.predicted,
                        slo=req.slo,
                    )
            # latency covers this group's tuning + execution only, not other
            # objective groups tuned later in the same batch
            dt = time.perf_counter() - t_group
            for req in group:
                req.latency_s = dt
        self.batches_served += 1
        self.requests_served += len(requests)
        self._served_since_calibration += len(requests)
        if (
            self.calibrate_every > 0
            and self.session.telemetry is not None
            and self._served_since_calibration >= self.calibrate_every
        ):
            self.session.calibrate()
            self.calibrations += 1
            self._served_since_calibration = 0
        # active observability, once per batch: advance the alert state
        # machines, let the residual watchdog judge fresh calibration pairs,
        # and sync the fleet posterior when the request budget says so
        if self.slo is not None:
            self.slo.evaluate()
        if self.watchdog is not None:
            fired = self.watchdog.poll()
            if fired:
                self.anomaly_fires += len(fired)
        if self.fleet is not None:
            self.fleet.maybe_sync(len(requests))
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
        if self.calibrate_every > 0:
            out["calibrations"] = self.calibrations
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.watchdog is not None:
            out["anomaly"] = self.watchdog.summary()
        if self.fleet is not None:
            out["fleet"] = self.fleet.summary()
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
        """Export this instance's observability shards (fleet aggregation
        input): a metrics JSONL shard, a trace JSONL shard, and the summary
        (with energy/latency aggregates) as JSON. Returns path strings.

        The trace shard holds the spans collected since the last export;
        the process tracer is left on, so the runs the next dump exports
        are traced (a caller that wants this run's spans switches it on
        first: ``obs.trace.tracing()``)."""
        import json
        from pathlib import Path

        from repro_torch.utils.io import atomic_write_text

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        metrics_path = out_dir / f"metrics-{instance}.jsonl"
        trace_path = out_dir / f"trace-{instance}.jsonl"
        summary_path = out_dir / f"summary-{instance}.json"
        self.metrics.write_shard(metrics_path, instance)
        tracer = get_tracer()
        tracer.export_jsonl(trace_path)
        tracer.enabled = True
        atomic_write_text(
            summary_path, json.dumps(self.summary(), indent=1, default=float)
        )
        log.info("observability shards -> %s", out_dir)
        return {
            "metrics": str(metrics_path),
            "trace": str(trace_path),
            "summary": str(summary_path),
        }

    def start_metrics_server(
        self, port: int = 0, *, host: str = "127.0.0.1"
    ) -> ObsHTTPServer:
        """Serve ``/metrics`` + ``/healthz`` + ``/obs`` (+ ``/slo`` when a
        tracker is attached) from a daemon thread."""
        if self._obs_http is None:
            self._obs_http = ObsHTTPServer(
                self.metrics,
                extra=self.summary,
                slo=self.slo.snapshot if self.slo is not None else None,
                host=host,
                port=port,
            )
            self._obs_http.start()
            log.info("metrics endpoint at %s/metrics", self._obs_http.url)
        return self._obs_http

    def stop_metrics_server(self) -> None:
        if self._obs_http is not None:
            self._obs_http.stop()
            self._obs_http = None
