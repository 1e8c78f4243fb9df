"""Batched serving example on the PyTorch and CUDA port: continuous-batching-lite
over a small model with KV/state caches.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma-2b \
      --requests 6 --slots 3

``--sparse`` magnitude-prunes the FFN weights and serves their matmuls
through session-planned SpMV kernels (the Auto-SpMV sparse-serving path):
it first runs a one-step dense-vs-sparse numerics check on the same pruned
params, then serves the request stream with per-request SLO classes.

  PYTHONPATH=src python examples/torch_serve_lm.py --sparse --requests 2 --slots 1
  PYTHONPATH=src python examples/torch_serve_lm.py --sparse --device cpu   # no card

The flow, flags and printed lines are ``examples/serve_lm.py``'s; ``--device``
(default: the card, raising where there is none) is where the model and
the kernels run.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params, model_specs
from repro_torch.train.serve import BatchedServer, Request, ServeConfig


def build_sparse_engine(cfg, params, density, device):
    """Cheap tuner + shared session + engine over the pruned FFN weights."""
    from repro_torch.core.session import AutoSpmvSession, build_tuner
    from repro_torch.models.sparse_linear import SparseInferenceEngine, prune_model_ffns
    from repro_torch.sparse.generate import MATRIX_NAMES

    tuner = build_tuner(
        scale=0.0008, names=MATRIX_NAMES[:3], n_extra=0, fit_overhead=False, device=device
    )
    engine = SparseInferenceEngine(AutoSpmvSession(tuner))
    pruned = prune_model_ffns(params, cfg, engine, density=density)
    return engine, pruned


def check_numerics(cfg, params, engine, device) -> dict:
    """One decode step, dense vs sparse-served, on the SAME pruned params:
    the SpMV route must reproduce the dense logits within fp32 tolerance.
    Returns the figure and both steps' logits (host arrays)."""
    from repro_torch.models.model import decode_step, init_cache, prefill

    B, T = 1, 6
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)),
        dtype=torch.int32, device=device,
    )
    cache = init_cache(cfg, B, 64, device)
    logits, cache, _ = prefill(params, cfg, cache, tokens=tokens)
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((B, 1), T, dtype=torch.int32, device=device)
    ld, _ = decode_step(params, cfg, cache, nxt, pos)
    engine.plan_all("latency")
    ls, _ = decode_step(
        params, cfg, cache, nxt, pos,
        unroll_layers=True, engine=engine.bind("latency"),
    )
    ld, ls = ld.float().cpu().numpy(), ls.float().cpu().numpy()
    err = float(np.max(np.abs(ld - ls)))
    print(f"dense-vs-sparse decode logits: max abs diff {err:.2e}")
    assert err < 5e-4, f"sparse-served logits diverged from dense: {err}"
    return {"max_abs_diff": err, "max_abs_logit": float(np.abs(ld).max()),
            "compute_dtype": cfg.compute_dtype, "dense": ld, "sparse": ls}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sparse", action="store_true",
                    help="serve FFN matmuls through planned SpMV kernels")
    ap.add_argument("--density", type=float, default=0.05,
                    help="with --sparse: kept-weight fraction per FFN matrix")
    ap.add_argument("--slo", default="mixed",
                    choices=["latency-critical", "power-capped", "balanced",
                             "energy-saving", "mixed"])
    ap.add_argument("--device", default=None,
                    help="where the model and kernels run (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, reduced_config=True)
    if cfg.prefix_len:
        cfg = cfg.replace(prefix_len=0, prefix_lm=False)  # text-only demo
    if args.sparse and cfg.n_experts and cfg.dispatch_format != "dense":
        cfg = cfg.replace(dispatch_format="dense")  # engine needs dense dispatch
    print(f"serving {cfg.name}: {cfg.param_counts()['total']/1e6:.1f}M params, "
          f"{args.slots} slots")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_specs(cfg), gen, cfg.param_dtype, device=device)
    engine = numerics = None
    if args.sparse:
        engine, params = build_sparse_engine(cfg, params, args.density, device)
        print(f"sparse engine: {engine.stats.registered} FFN matrices pruned to "
              f"density {args.density} ({engine.stats.spmv_layers} SpMV-eligible)")
        numerics = check_numerics(cfg, params, engine, device)
    server = BatchedServer(
        params, cfg,
        ServeConfig(batch_slots=args.slots, max_len=256,
                    max_new_tokens=args.max_new_tokens),
        engine=engine,
    )
    rng = np.random.default_rng(args.seed)
    slos = ["latency-critical", "power-capped", "balanced", "energy-saving"]
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 20))).tolist(),
                max_new_tokens=args.max_new_tokens,
                slo=slos[i % len(slos)] if args.slo == "mixed" else args.slo)
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = server.run(reqs)
    dt = time.time() - t0
    total = sum(len(r.generated) for r in done)
    for r in done:
        print(f"  req {r.rid} [{r.slo}]: {len(r.prompt)}-token prompt -> "
              f"{r.generated[:8]}...")
    print(f"{total} tokens in {dt:.1f}s ({total/dt:.1f} tok/s aggregate, "
          f"{args.slots}-way batched)")
    s = server.summary()
    if engine is not None:
        print(f"slo classes: {s['slo_classes']}")
        print(f"engine plans: {s['engine']['stats']['plans']} "
              f"({s['session']['requests']} session plan requests)")
        print(f"energy cells: {sorted(s.get('energy', {}))}")
    return {"done": done, "numerics": numerics, "summary": s, "seconds": dt}


if __name__ == "__main__":
    main()
