"""Quickstart: Auto-SpMV end to end on one matrix, on the PyTorch and CUDA port.

  PYTHONPATH=src python examples/torch_quickstart.py [--matrix consph] [--objective latency]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # no card: plain versions

Flow (paper Fig. 5), as ``examples/quickstart.py`` runs it on the reference:
build the tuning dataset -> train predictors -> compile-time mode (predict
the kernel schedule, specialise the CSR kernel) -> run-time mode (predict
the best format, check the conversion overhead, convert) -> execute both
kernels and verify against the dense product.

``--device`` (default: the card, raising where there is none) is where the
kernels run. The tuner learns as ``build_tuner`` does there: on a card with
the card's cost model, each training matrix also at the size the card
serves, and the card's §5.3 predictor; on the CPU with the reference's
cost model and predictor, so its decisions are the reference's.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import AutoSpMV, AutoSpmvPredictor, PredictorConfig
from repro_torch.core.session import default_cost_model, overhead_predictor, tuning_dataset
from repro_torch.kernels.common import resolve_device
from repro_torch.sparse.generate import MATRIX_NAMES, generate_by_name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="consph", choices=sorted(MATRIX_NAMES))
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy", "power", "efficiency"])
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--iterations", type=int, default=5000,
                    help="solver iterations amortizing the conversion cost")
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = default_cost_model(device)

    print(f"[1/4] collecting tuning dataset ({type(model).__name__} over the suite)...")
    t0 = time.time()
    ds = tuning_dataset(args.scale, MATRIX_NAMES[:16], 8, model)
    print(f"      {len(ds)} records in {time.time()-t0:.1f}s")

    print("[2/4] training predictors (decision tree, paper Table 5 winner)...")
    pred = AutoSpmvPredictor(PredictorConfig(device=device)).fit(ds)
    overhead = overhead_predictor(args.scale, MATRIX_NAMES[:8], model, device)
    tuner = AutoSpMV(pred, overhead, device=device, cost_model=model)

    dense = generate_by_name(args.matrix, scale=args.scale)
    x = np.random.default_rng(0).normal(size=dense.shape[1]).astype(np.float32)
    ref = dense @ x

    print(f"[3/4] compile-time mode ({args.objective}) on {args.matrix}...")
    ct = tuner.compile_time_optimize(dense, args.objective)
    y = ct.kernel(x).cpu().numpy()
    err = np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9)
    print(f"      schedule: {ct.schedule}")
    print(f"      predicted objectives: "
          + ", ".join(f"{k}={v:.3g}" for k, v in ct.predicted.items()))
    print(f"      kernel correct: rel.err {err:.2e}")

    print(f"[4/4] run-time mode ({args.objective})...")
    rt = tuner.run_time_optimize(
        dense, args.objective, n_iterations=args.iterations
    )
    print(f"      best format: {rt.best_format}; convert: {rt.convert} "
          f"(gain/iter {rt.predicted_gain_per_iter:.3g}, "
          f"overhead {rt.predicted_overhead*1e3:.1f} ms)")
    out = {"schedule": ct.schedule, "kernel_err": float(err), "best_format": rt.best_format,
           "convert": rt.convert, "gain_per_iter": rt.predicted_gain_per_iter,
           "overhead_s": rt.predicted_overhead, "converted": None}
    if rt.kernel is not None:
        y2 = rt.kernel(x).cpu().numpy()
        err2 = np.abs(y2 - ref).max() / (np.abs(ref).max() + 1e-9)
        print(f"      converted kernel correct: rel.err {err2:.2e}")
        out["converted"] = {"format": rt.best_format, "schedule": rt.kernel.schedule,
                            "err": float(err2)}
    print("done.")
    return out


if __name__ == "__main__":
    main()
