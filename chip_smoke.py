#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``): the quickest
proof that the port builds, launches and serves on an NVIDIA Hopper card.

Run it from the root of a checkout, with no arguments, on a machine with one
CUDA device, ``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py

It imports ``repro_torch`` only (never JAX, never the JAX package) and needs
no network. Phases, each printing one JSON object on a line of its own:

1. ``env``      torch / CUDA / nvcc versions, card name and power limit.
2. ``build``    compiles ``src/repro_torch/csrc/*.cu`` for sm_90a (one
                ``nvcc`` per source, in parallel) and reports the seconds.
3. ``check``    every hand-written kernel against its plain PyTorch version
                on the card, over six schedules, at the shapes the served
                path gives it; a disagreement beyond the stated tolerance
                raises. Also times kernel, plain version and, where one
                PyTorch call computes the same function, that call.
4. ``serve``    ``SpmvServer.run`` (tuner from ``build_tuner()``) on 16 requests with
                repeats over six full-width matrices (``human_gene2`` at its
                published 14,340 x 14,340 with ~9.0 M nonzeros, five more
                scaled to n ~ 14,000). Every ``y`` is held against a float64
                host product.
5. ``runtime_mode``  ``session.run_time_optimize`` for every pool matrix and
                the four objectives, then ``compile_spmv`` for ELL, SELL and
                BELL (BELL on the largest block matrix its storage guard
                admits, n = 8,000), each checked against the host product.

Launch counters are set to 0 just before phases 4 and 5 and read just after:
a kernel of the path that was launched no time fails the run. Then come the
``kernels`` line (phase 3's numbers with the main path's launch counts), the
``nvidia-smi`` name/power-limit line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed phase raises and the exit code
is not 0; without a CUDA device the script exits at once with code 2 and
prints no result.

Tolerances (scaled by max |reference|, as the package's tests do): 1e-4 for
float32 accumulation (summation order differs), 3e-2 for bfloat16
accumulation (every product and running sum is rounded to 8 significand
bits; the plain version rounds products the same way but sums in float32).
"""

from __future__ import annotations

import json
import os
import warnings
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA "
          "device", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402

from repro_torch.core.features import extract_features  # noqa: E402
from repro_torch.core.session import AutoSpmvSession, build_tuner  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.bell import bell_spmv, bell_spmv_plain  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    DEFAULT_SCHEDULE,
    InfeasibleConfig,
    KernelSchedule,
    ceil_to,
)
from repro_torch.kernels.csr import csr_spmv, csr_spmv_plain  # noqa: E402
from repro_torch.kernels.ell import ell_spmv, ell_spmv_plain  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    compile_spmv,
    matrix_fingerprint,
    prepare,
)
from repro_torch.kernels.sell import sell_spmv, sell_spmv_plain  # noqa: E402
from repro_torch.sparse.generate import SUITE, generate_by_name  # noqa: E402
from repro_torch.train.serve import SpmvRequest, SpmvServer  # noqa: E402
from repro_torch.utils.timing import cuda_time_ms  # noqa: E402

DEVICE = torch.device("cuda", 0)
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
N_TARGET = 14_000  # rows of the scaled pool matrices
# BELL's storage guard (check_storage_bytes, 512 MiB at 8 bytes per element of
# the occupancy bound) admits a block-structured matrix up to n ~ 8,000: that
# is the largest BELL the dense-input API serves, so BELL runs at that size
BELL_MATRIX, BELL_N = "pkustk04@8000", 8_000
N_REQUESTS = 16
OBJECTIVES = ("latency", "energy", "power", "efficiency")
POOL = ("human_gene2", "rim", "bcsstk32", "viscorocks", "pkustk04", "amazon0601")

# the six schedules of the package's kernel tests
SCHEDULES = [
    DEFAULT_SCHEDULE,
    KernelSchedule(rows_per_block=8, nnz_tile=128, unroll=1),
    KernelSchedule(rows_per_block=32, nnz_tile=256, unroll=2),
    KernelSchedule(rows_per_block=128, nnz_tile=512, unroll=4),
    KernelSchedule(rows_per_block=16, nnz_tile=128, unroll=1, accum_dtype="bfloat16"),
    KernelSchedule(rows_per_block=64, nnz_tile=128, dimension_semantics="parallel"),
]

WRAPPERS = {"csr": csr_spmv, "ell": ell_spmv, "sell": sell_spmv, "bell": bell_spmv}
REPLACES = {
    "csr": "src/repro/kernels/csr.py:48",
    "ell": "src/repro/kernels/ell.py:45",
    "sell": "src/repro/kernels/sell.py:54",
    "bell": "src/repro/kernels/bell.py:40",
}
# matrix each kernel is checked and timed on: one the served path gives it
CHECK_MATRIX = {"csr": "human_gene2", "ell": "rim", "sell": "rim", "bell": BELL_MATRIX}


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}, default=float), flush=True)


def tol_of(schedule: KernelSchedule) -> float:
    return 3e-2 if schedule.accum_dtype == "bfloat16" else 1e-4


def scaled_err(y: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))


def sched_tag(s: KernelSchedule) -> str:
    return (f"rpb{s.rows_per_block}_nt{s.nnz_tile}_u{s.unroll}_"
            f"{'bf16' if s.accum_dtype == 'bfloat16' else 'f32'}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# ------------------------------------------------------------------ inputs
def make_pool() -> dict[str, np.ndarray]:
    pool = {}
    for name in POOL:
        spec = SUITE[name]
        if name == "human_gene2":
            pool[name] = generate_by_name(name, scale=1.0, max_elems=spec.n**2)
        else:
            pool[name] = generate_by_name(name, scale=N_TARGET / spec.n)
    return pool


def make_bell_matrix() -> np.ndarray:
    return generate_by_name("pkustk04", scale=BELL_N / SUITE["pkustk04"].n)


def host_product(dense: np.ndarray, x: np.ndarray) -> np.ndarray:
    return dense.astype(np.float64) @ x.astype(np.float64)


# ------------------------------------------------- per-kernel call closures
def kernel_calls(fmt: str, mat, x: torch.Tensor, schedule: KernelSchedule):
    """(kernel call, plain call, input tensors, output elements, flops) for
    one prepared matrix, at exactly the arguments the registry's spmv hands
    the wrapper."""
    if fmt == "csr":
        args = (mat.data, mat.indices, mat.indptr, x, schedule)
        ins, fl = (mat.data, mat.indices, mat.indptr, x), 2 * mat.data.shape[0]
        out_elems = mat.shape[0]
        return (lambda: csr_spmv(*args)), (lambda: csr_spmv_plain(*args)), ins, out_elems, fl
    if fmt == "ell":
        args = (mat.data, mat.cols, x, schedule)
        ins, fl = (mat.data, mat.cols, x), 2 * mat.data.numel()
        return (lambda: ell_spmv(*args)), (lambda: ell_spmv_plain(*args)), ins, mat.data.shape[0], fl
    if fmt == "sell":
        args = (mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x, mat.C, schedule)
        ins = (mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x)
        fl = 2 * mat.data.numel()
        return (lambda: sell_spmv(*args)), (lambda: sell_spmv_plain(*args)), ins, mat.n_slices * mat.C, fl
    if fmt == "bell":
        n_cols = mat.shape[1]
        xp = torch.zeros(ceil_to(n_cols, mat.bc), dtype=x.dtype, device=x.device)
        xp[:n_cols] = x
        panels = xp.reshape(-1, mat.bc)
        args = (mat.data, mat.block_cols, panels, schedule)
        ins, fl = (mat.data, mat.block_cols, panels), 2 * mat.data.numel()
        return (lambda: bell_spmv(*args)), (lambda: bell_spmv_plain(*args)), ins, mat.data.shape[0] * mat.br, fl
    raise ValueError(fmt)


def bound(ins, out_elems: int, flops: int) -> tuple[float, str, int]:
    """Least time the card could take: each input read once, the output
    written once, against the HBM rate; the operations against the fp32
    rate. Returns (ms, which bound, bytes)."""
    nbytes = sum(t.numel() * t.element_size() for t in ins) + 4 * out_elems
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def timed(fn, reps: int = 20) -> float:
    """Median ms by CUDA events, the L2 flushed before every repetition (as
    a served request finds it)."""
    return cuda_time_ms(fn, warmup=3, reps=reps)["median_ms"]


def check_kernel(fmt: str, name: str, dense: np.ndarray, time_schedule: KernelSchedule) -> dict:
    """Hold one kernel against its plain version over the six schedules and
    time it at ``time_schedule`` (the one the served path uses for it)."""
    rng = np.random.default_rng(SEED + 7)
    x_host = rng.normal(size=dense.shape[1]).astype(np.float32)
    x = torch.as_tensor(x_host, device=DEVICE)
    ref64 = host_product(dense, x_host)
    n_rows = dense.shape[0]
    worst, per_schedule = 0.0, {}
    schedules = list(SCHEDULES)
    if time_schedule not in schedules:
        schedules.append(time_schedule)
    entry = None
    for sched in schedules:
        mat = prepare(dense, fmt, sched, device=DEVICE)
        kern, plain, ins, out_elems, flops = kernel_calls(fmt, mat, x, sched)
        y_k = kern()
        torch.cuda.synchronize()  # a fault during the run surfaces here
        y_p = plain()
        yk = y_k.reshape(-1)[:n_rows].cpu().numpy()
        yp = y_p.reshape(-1)[:n_rows].cpu().numpy()
        err = scaled_err(yk, yp)
        err_host = scaled_err(yk, ref64)
        tol = tol_of(sched)
        if not (np.isfinite(yk).all() and err <= tol and err_host <= tol):
            raise AssertionError(
                f"{fmt} kernel disagrees on {name} at {sched}: vs plain {err:.3e}, "
                f"vs host float64 {err_host:.3e}, tolerance {tol:.0e}"
            )
        worst = max(worst, err)
        ms = timed(kern)
        per_schedule[sched_tag(sched)] = {"ms": ms, "err_vs_plain": err, "err_vs_host": err_host}
        if sched == time_schedule:
            bound_ms, bound_by, nbytes = bound(ins, out_elems, flops)
            entry = {
                "matrix": name,
                "shape": list(dense.shape),
                "nnz": int((dense != 0).sum()),
                "schedule": sched_tag(sched),
                "ms": ms,
                "plain_ms": timed(plain, reps=5),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "bytes": nbytes,
                "library_ms": None,
            }
            if fmt == "csr":
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # "sparse CSR is beta" notices
                    a = torch.sparse_csr_tensor(
                        mat.indptr, mat.indices, mat.data, size=mat.shape, device=DEVICE
                    )
                y_l = (a @ x).cpu().numpy()
                entry["library_err"] = scaled_err(y_l, ref64)
                entry["library_ms"] = timed(lambda: a @ x)
                del a
        del mat
    entry["max_abs_err"] = worst
    entry["tolerance"] = {"float32": 1e-4, "bfloat16": 3e-2}
    entry["by_schedule"] = per_schedule
    return entry


# -------------------------------------------------------------------- main
def main() -> None:
    t_all = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc_version = run([kbuild.find_nvcc(), "--version"]).splitlines()[-2:]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc_version, card=smi,
         device=torch.cuda.get_device_name(0))

    built = kbuild.build_all()
    emit("build", seconds=built["seconds"], built=built["built"],
         dir=os.path.relpath(str(kbuild.build_dir()), HERE))

    t0 = time.perf_counter()
    pool = make_pool()
    extra = {BELL_MATRIX: make_bell_matrix()}
    fps = {n: matrix_fingerprint(d) for n, d in pool.items()}
    emit("inputs", seconds=time.perf_counter() - t0,
         pool={n: {"shape": list(d.shape), "nnz": int((d != 0).sum())}
               for n, d in {**pool, **extra}.items()})

    # ---- every kernel against its plain version, and its times ----------
    t0 = time.perf_counter()
    tuner = build_tuner()  # device=None: the card
    tuner_s = time.perf_counter() - t0
    # the schedule compile-time mode will serve human_gene2's CSR kernel with
    csr_schedule = tuner.plan_compile_time(
        extract_features(pool["human_gene2"]), "latency"
    ).schedule
    t0 = time.perf_counter()
    checked = {}
    for fmt in ("csr", "ell", "sell", "bell"):
        name = CHECK_MATRIX[fmt]
        sched = csr_schedule if fmt == "csr" else DEFAULT_SCHEDULE
        checked[fmt] = check_kernel(fmt, name, {**pool, **extra}[name], sched)
    torch.cuda.empty_cache()
    emit("check", seconds=time.perf_counter() - t0, tuner_seconds=tuner_s,
         kernels={f: {k: e[k] for k in ("matrix", "schedule", "max_abs_err", "ms")}
                  for f, e in checked.items()})

    # ---- serve: the main path, compile-time mode (CSR kernel) -----------
    session = AutoSpmvSession(tuner)
    server = SpmvServer(session)
    rng = np.random.default_rng(SEED)
    names = [str(rng.choice(POOL)) for _ in range(N_REQUESTS)]
    names[0] = "human_gene2"  # the published-size matrix is always served
    reqs = []
    for i, n in enumerate(names):
        x = rng.normal(size=pool[n].shape[1]).astype(np.float32)
        reqs.append(SpmvRequest(rid=i, dense=pool[n], x=x, objective="latency"))
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    server.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    served = []
    for r, n in zip(reqs, names):
        ref = host_product(r.dense, r.x)
        err, tol = scaled_err(r.y, ref), tol_of(r.schedule)
        ok = r.y.shape == ref.shape and bool(np.isfinite(r.y).all()) and err <= tol
        served.append({"rid": r.rid, "matrix": n, "hit": r.cache_hit, "err": err,
                       "tol": tol, "schedule": sched_tag(r.schedule)})
        if not ok:
            raise AssertionError(f"served request {r.rid} ({n}) wrong: err {err:.3e} > {tol:.0e}")
    stats = session.stats.as_dict()
    if launches["csr"] != N_REQUESTS:
        raise AssertionError(f"CSR kernel launched {launches['csr']} times for {N_REQUESTS} requests")
    if not (stats["plans_computed"] < N_REQUESTS and stats["kernel_compiles"] < N_REQUESTS):
        raise AssertionError(f"no amortisation: {stats}")
    spans = server.summary()
    from repro_torch.obs.trace import get_tracer

    by_name = get_tracer().summary()["by_name"]
    emit("serve", seconds=serve_s, requests=served,
         session=stats, launches=launches, latency=spans.get("latency"),
         span_seconds={k: v["total_s"] for k, v in by_name.items()},
         span_counts={k: v["count"] for k, v in by_name.items()})
    if reqs[0].schedule != csr_schedule:
        raise AssertionError(
            f"human_gene2 was served with {reqs[0].schedule}, timed at {csr_schedule}"
        )

    # ---- run-time mode: format choice + ELL / SELL / BELL kernels --------
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    decisions = []
    rng = np.random.default_rng(SEED + 1)
    for n, dense in pool.items():
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        ref = None
        for obj in OBJECTIVES:
            try:
                res = session.run_time_optimize(
                    dense, obj, n_iterations=10_000, fingerprint=fps[n]
                )
            except InfeasibleConfig as exc:
                # the chosen format's storage guard refused this matrix while
                # converting: the reference behaves the same; reported as is
                decisions.append({"matrix": n, "objective": obj, "infeasible": str(exc)})
                continue
            row = {"matrix": n, "objective": obj, "format": res.best_format,
                   "gain_per_iter": res.predicted_gain_per_iter,
                   "overhead_s": res.predicted_overhead, "convert": res.convert}
            if res.kernel is not None:
                ref = host_product(dense, x) if ref is None else ref
                y = res.kernel(x).cpu().numpy()
                row["err"] = scaled_err(y, ref)
                if row["err"] > tol_of(res.kernel.schedule):
                    raise AssertionError(f"run-time kernel wrong: {row}")
            decisions.append(row)
    direct = []
    infeasible_ok = {("bell", "pkustk04"), ("bell", "human_gene2")}
    for fmt, n in (("ell", "rim"), ("sell", "rim"), ("bell", BELL_MATRIX),
                   ("bell", "pkustk04"), ("bell", "human_gene2")):
        dense = {**pool, **extra}[n]
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        try:
            kernel = compile_spmv(dense, fmt, DEFAULT_SCHEDULE, device=DEVICE)
        except InfeasibleConfig as exc:
            if (fmt, n) not in infeasible_ok:
                raise
            # the storage guard refusing BELL at n ~ 14,000 is the reference
            # behaviour; it is reported, not hidden
            direct.append({"format": fmt, "matrix": n, "infeasible": str(exc)})
            continue
        y = kernel(x).cpu().numpy()
        err = scaled_err(y, host_product(dense, x))
        direct.append({"format": fmt, "matrix": n, "err": err})
        if not (np.isfinite(y).all() and err <= 1e-4):
            raise AssertionError(f"compile_spmv({fmt}) on {n} wrong: err {err:.3e}")
        del kernel
    torch.cuda.synchronize()
    rt_launches = {k: w.launches for k, w in WRAPPERS.items()}
    for k in ("ell", "sell", "bell"):
        launches[k] = rt_launches[k]
    launches["csr"] += rt_launches["csr"]
    emit("runtime_mode", seconds=time.perf_counter() - t0, decisions=decisions,
         direct=direct, launches=rt_launches, session=session.stats.as_dict())
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    kernels = [
        {
            "name": f"{fmt}_spmv",
            "route": "cuda",
            "source": f"src/repro_torch/csrc/spmv_{fmt}.cu",
            "replaces": REPLACES[fmt],
            "launches": launches[fmt],
            **checked[fmt],
        }
        for fmt in ("csr", "ell", "sell", "bell")
    ]
    emit("done", total_seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
