"""Run-time-mode demo over the matrix suite, on the PyTorch and CUDA port:
per-objective format selection + conversion decisions, printed as the
paper's Fig. 5(b) pipeline would execute inside an iterative solver.

Tuning goes through ``AutoSpmvSession.optimize_many`` so the whole batch is
deduplicated and the decisions land in a cache (pass ``--cache`` to persist
them; a second run then starts warm and skips the predictor inferences).
The flow, flags and table are ``examples/autotune_formats.py``'s; the last
line adds what the reference's demo leaves out: each matrix's product
through the kernel it keeps or converts to, against the dense product.

  PYTHONPATH=src python examples/torch_autotune_formats.py --objective efficiency
  PYTHONPATH=src python examples/torch_autotune_formats.py --device cpu   # no card

``--device`` (default: the card, raising where there is none) is where the
kernels run; the tuner learns as ``build_tuner`` does there (see
``examples/torch_quickstart.py``).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import AutoSpMV, AutoSpmvPredictor, AutoSpmvSession, PredictorConfig
from repro_torch.core.session import default_cost_model, overhead_predictor, tuning_dataset
from repro_torch.kernels.common import DEFAULT_SCHEDULE, resolve_device
from repro_torch.kernels.ops import compile_spmv
from repro_torch.sparse.generate import MATRIX_NAMES, generate_by_name
from repro_torch.sparse.registry import default_format


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objective", default="efficiency",
                    choices=["latency", "energy", "power", "efficiency"])
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--n-matrices", type=int, default=12)
    ap.add_argument("--cache", default=None,
                    help="JSON path for the persistent tuning cache")
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = default_cost_model(device)

    names = MATRIX_NAMES[: args.n_matrices]
    ds = tuning_dataset(args.scale, names, 8, model)
    pred = AutoSpmvPredictor(PredictorConfig(device=device)).fit(ds)
    oh = overhead_predictor(args.scale, names[:8], model, device)
    session = AutoSpmvSession(AutoSpMV(pred, oh, device=device, cost_model=model),
                              cache_path=args.cache)

    mats = [generate_by_name(m, scale=args.scale) for m in names]
    results = session.optimize_many(
        mats, args.objective, mode="run", n_iterations=args.iterations
    )
    print(f"{'matrix':22s} {'format':6s} {'convert':8s} {'gain/iter':>10s} {'overhead':>9s}")
    for m, rt in zip(names, results):
        print(f"{m:22s} {rt.best_format:6s} {str(rt.convert):8s} "
              f"{rt.predicted_gain_per_iter:10.3g} {rt.predicted_overhead*1e3:8.1f}ms")
    s = session.stats
    print(f"\nsession: {s.feature_extractions} feature passes, "
          f"{s.plans_computed} plans, {s.kernel_compiles} kernel compiles "
          f"for {s.requests} matrices")
    if args.cache:
        session.save()
        print(f"tuning cache saved to {args.cache}")

    # each matrix through the kernel it is left with: the converted storage,
    # else the current format's at the default schedule
    rng = np.random.default_rng(0)
    errs = []
    for dense, rt in zip(mats, results):
        kernel = rt.kernel if rt.kernel is not None else compile_spmv(
            dense, default_format(), DEFAULT_SCHEDULE, device=device)
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        ref = dense @ x
        y = kernel(x).cpu().numpy()
        errs.append({"format": type(kernel.mat).__name__.lower(), "schedule": kernel.schedule,
                     "err": float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))})
    worst = max(errs, key=lambda e: e["err"])
    print(f"kernels correct: {len(errs)} products, worst rel.err {worst['err']:.2e} "
          f"({sum(rt.kernel is not None for rt in results)} through converted storage)")
    rows = [{"matrix": m, "format": rt.best_format, "convert": rt.convert,
             "gain_per_iter": rt.predicted_gain_per_iter, "overhead_s": rt.predicted_overhead}
            for m, rt in zip(names, results)]
    return {"rows": rows, "session": s.as_dict(), "checks": errs}


if __name__ == "__main__":
    main()
