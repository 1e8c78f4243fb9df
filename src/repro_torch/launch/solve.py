"""Iterative-solver launcher: ``python -m repro_torch.launch.solve --solver
pagerank --matrix webgraph [--adaptive-spmspv] [--device cuda|cpu]``.

The solve-side twin of ``launch.serve``: where serve streams single-shot
SpMV requests, this drives one *iterative solve* (PageRank / CG / power
iteration) through an ``AutoSpmvSession`` — one ``serve_optimize`` plan,
then every iteration replays the cached kernel on ``--device`` (default
``cuda``; the launcher raises when the card is absent rather than solving on
the CPU) with ``observe()`` feedback. With ``--adaptive-spmspv`` the
per-iteration SpMV↔SpMSpV policy is attached, backed by a UCB phase bandit
(``telemetry.adaptive.phase_arm_bucket``) that learns the density
crossover online; sparse frontiers then run the SpMSpV kernel.

``--matrix`` accepts a suite name (``repro_torch.sparse.generate.SUITE``) or
a bare pattern name (``fem``, ``webgraph``, ...); suite names win. CG
symmetrizes the matrix into an SPD operator (``(A + Aᵀ)/2`` plus a
diagonal dominance margin) since CG's contract requires one.

Convergence metadata is always written as JSON (default
``artifacts/solve/SOLVE_<solver>_<matrix>.json``) so CI and fleets can
assert on the emitted artifact rather than parse logs.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core.session import AutoSpmvSession, build_tuner
from repro_torch.kernels.common import resolve_device
from repro_torch.sparse.generate import (
    MATRIX_NAMES,
    PATTERN_NAMES,
    SUITE,
    generate_by_name,
    random_matrix,
)
from repro_torch.utils.logging import get_logger

log = get_logger("launch.solve")

SOLVER_NAMES = ("pagerank", "cg", "power")


def resolve_matrix(name: str, scale: float, seed: int) -> np.ndarray:
    """Suite name or pattern name -> dense matrix (suite names win)."""
    if name in SUITE:
        return generate_by_name(name, scale=scale)
    if name in PATTERN_NAMES:
        n = max(int(200_000 * scale), 96)
        return random_matrix(n, avg_nnz=8.0, pattern=name, seed=seed)
    raise SystemExit(
        f"unknown matrix {name!r}: expected a suite name "
        f"({', '.join(MATRIX_NAMES[:4])}, ...) or a pattern "
        f"({', '.join(PATTERN_NAMES)})"
    )


def spd_operator(dense: np.ndarray) -> np.ndarray:
    """Symmetrize + diagonally dominate: the SPD system CG contracts for."""
    A = np.asarray(dense, dtype=np.float32)
    S = (A + A.T) / 2
    margin = float(np.abs(S).sum(axis=1).max()) + 1.0
    return (S + margin * np.eye(S.shape[0], dtype=np.float32)).astype(np.float32)


def run_solve(args):
    device = resolve_device(args.device)
    t0 = time.time()
    tuner = build_tuner(
        scale=args.scale, names=MATRIX_NAMES[: args.train_matrices], device=device
    )
    log.info("tuner ready in %.1fs (device %s)", time.time() - t0, device)
    session = AutoSpmvSession(tuner, cache_path=args.cache)

    policy = None
    if args.adaptive_spmspv:
        from repro_torch.solvers import AdaptiveSpmvPolicy
        from repro_torch.telemetry import AdaptiveFormatSelector

        policy = AdaptiveSpmvPolicy(selector=AdaptiveFormatSelector())
        log.info(
            "adaptive SpMV<->SpMSpV routing: threshold prior %.0f%%, "
            "%d density phases under the UCB bandit",
            policy.threshold * 100,
            policy.n_phases,
        )

    dense = resolve_matrix(args.matrix, args.scale, args.seed)
    n = dense.shape[0]
    nnz = int((dense != 0).sum())
    log.info("matrix %s: n=%d nnz=%d", args.matrix, n, nnz)

    from repro_torch.solvers import cg, pagerank, power_iteration

    if args.solver == "pagerank":
        result = pagerank(
            session,
            dense,
            damping=args.damping,
            tol=args.tol,
            max_iters=args.max_iters,
            policy=policy,
            objective=args.objective,
        )
    elif args.solver == "cg":
        rng = np.random.default_rng(args.seed)
        b = rng.standard_normal(n).astype(np.float32)
        result = cg(
            session,
            spd_operator(dense),
            b,
            tol=args.tol,
            max_iters=args.max_iters,
            policy=policy,
            objective=args.objective,
        )
    else:
        result = power_iteration(
            session,
            dense,
            tol=args.tol,
            max_iters=args.max_iters,
            policy=policy,
            objective=args.objective,
        )

    stats = session.stats
    log.info(
        "%s on %s: %d iters, converged=%s, residual=%.3g (p50 iter %.2f ms); "
        "%d plan(s) computed, %d kernel compiles, cache %s",
        args.solver,
        args.matrix,
        result.iterations,
        result.converged,
        result.residual,
        result.iter_p50_s() * 1e3,
        stats.plans_computed,
        stats.kernel_compiles,
        session.cache.stats(),
    )

    payload = {
        "matrix": args.matrix,
        "n": n,
        "nnz": nnz,
        "tol": args.tol,
        "max_iters": args.max_iters,
        "adaptive_spmspv": bool(args.adaptive_spmspv),
        **result.summary(),
        "session": {
            "plans_computed": stats.plans_computed,
            "kernel_compiles": stats.kernel_compiles,
            "cache_hits": stats.cache_hits,
            "observations": stats.observations,
        },
    }
    out = Path(
        args.json_out
        or f"artifacts/solve/SOLVE_{args.solver}_{args.matrix}.json"
    )
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=2, default=float) + "\n")
    log.info("solve metadata -> %s", out)

    if args.cache:
        session.save()
        log.info("tuning cache saved to %s", args.cache)
    if args.metrics_export:
        from repro_torch.obs import get_metrics

        get_metrics().write_shard(args.metrics_export, args.obs_instance)
        log.info("metrics shard -> %s", args.metrics_export)
    if args.trace_export:
        from repro_torch.obs import get_tracer

        nspans = get_tracer().export_jsonl(args.trace_export)
        log.info("trace shard -> %s (%d spans)", args.trace_export, nspans)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--solver", required=True, choices=SOLVER_NAMES,
                    help="iterative solver to run")
    ap.add_argument("--matrix", default="webgraph",
                    help="suite matrix name or generator pattern")
    ap.add_argument("--scale", type=float, default=0.0008,
                    help="suite scale factor (matches the bench smoke tier)")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: 'cuda' (default; raises when "
                         "no card is present) or 'cpu' (plain PyTorch versions)")
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="convergence tolerance (solver-specific residual)")
    ap.add_argument("--damping", type=float, default=0.85,
                    help="pagerank damping factor")
    ap.add_argument("--adaptive-spmspv", action="store_true",
                    help="route each iteration SpMV vs SpMSpV by frontier "
                         "density, learned per density phase by the UCB "
                         "bandit")
    ap.add_argument("--cache", default=None,
                    help="JSON path for the persistent tuning cache")
    ap.add_argument("--train-matrices", type=int, default=4,
                    help="suite matrices used to fit the tuner's predictors")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy", "power", "efficiency"])
    ap.add_argument("--json-out", default=None,
                    help="convergence-metadata JSON path (default "
                         "artifacts/solve/SOLVE_<solver>_<matrix>.json)")
    ap.add_argument("--metrics-export", default=None,
                    help="write the metrics registry as a JSONL shard here "
                         "after solving")
    ap.add_argument("--trace-export", default=None,
                    help="append the collected spans as a JSONL shard here "
                         "after solving")
    ap.add_argument("--obs-instance", default="solve",
                    help="instance label stamped into exported shards")
    args = ap.parse_args(argv)
    return run_solve(args)


if __name__ == "__main__":
    main()
