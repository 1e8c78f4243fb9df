#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``): the quickest
proof that the port builds, launches and serves on an NVIDIA Hopper card.

Run it from the root of a checkout, with no arguments, on a machine with one
CUDA device, ``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py

It imports ``repro_torch`` only (never JAX, never the JAX package) and needs
no network. Phases, each printing one JSON object on a line of its own:

1. ``env``      torch / CUDA / nvcc versions, card name and power limit.
2. ``build``    compiles ``src/repro_torch/csrc/*.cu`` (six sources) for
                sm_90a (one ``nvcc`` per source, in parallel) and reports the
                seconds and each kernel's registers and spills (ptxas).
3. ``check``    every hand-written kernel against its plain PyTorch version
                and a float64 host product on the card, over six schedules,
                at the shapes the served path gives it; a disagreement beyond
                the stated tolerance raises. Also times kernel, plain version
                and, where one PyTorch call computes the same function, that
                call. The fused kernel runs on the stream ``lower_fused``
                makes from a forced four-block plan of ``hetero``, the BCSR
                kernel on ``pkustk04`` at n = 8,000.
4. ``serve``    ``SpmvServer.run`` (tuner from ``build_tuner()``) on 16 requests with
                repeats over six full-width matrices (``human_gene2`` at its
                published 14,340 x 14,340 with ~9.0 M nonzeros, five more
                scaled to n ~ 14,000). Every ``y`` is held against a float64
                host product.
5. ``runtime_mode``  ``session.run_time_optimize`` for every pool matrix and
                the four objectives, then ``compile_spmv`` for ELL, SELL and
                BELL (BELL on the largest block matrix its storage guard
                admits, n = 8,000), each checked against the host product.
6. ``partitioned``  8 requests with repeats over ``human_gene2`` (14,340^2),
                ``rim``, ``amazon0601`` and ``hetero`` (n = 14,000: a dense
                band stacked on a power-law half) through
                ``SpmvServer(partition=True)``, then 8 through
                ``SpmvServer(partition=True, fused=True)``; per request the
                block count, formats, modeled gain, cache hit and span
                seconds. Then a forced four-block plan of ``hetero`` through
                both executors. Block-kernel launches must add up to the
                blocks served, fused launches to the fused requests plus the
                forced run.
7. ``plugin``   registers BCSR (``repro_torch.sparse.bcsr``), runs run-time
                mode over the pool x 4 objectives, ``compile_spmv(.., "bcsr")``
                on ``pkustk04`` at n = 8,000 (and reports the storage guard's
                refusal at n ~ 14,000), and a forced plan with a BCSR block
                through both executors (the fused lowering's ``to_dense``
                route); unregisters BCSR at the end.

Launch counters are set to 0 just before phases 4-7 and read just after each:
a kernel of the path that was launched no time fails the run. Then come the
``kernels`` line (phase 3's numbers with the main path's launch counts), the
``nvidia-smi`` name/power-limit line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed phase raises and the exit code
is not 0; without a CUDA device the script exits at once with code 2 and
prints no result.

Tolerances (scaled by max |reference|, as the package's tests do): 1e-4 for
float32 accumulation (summation order differs; the fused kernel adds with
float atomics, so its low bits also vary from run to run), 3e-2 for bfloat16
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
from repro_torch.core.objectives import ObjectiveValues  # noqa: E402
from repro_torch.core.session import AutoSpmvSession, build_tuner  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.bcsr import bcsr_spmv, bcsr_spmv_plain  # noqa: E402
from repro_torch.kernels.bell import bell_spmv, bell_spmv_plain  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    DEFAULT_SCHEDULE,
    InfeasibleConfig,
    KernelSchedule,
    ceil_to,
)
from repro_torch.kernels.csr import csr_spmv, csr_spmv_plain  # noqa: E402
from repro_torch.kernels.ell import ell_spmv, ell_spmv_plain  # noqa: E402
from repro_torch.kernels.fused import fused_spmv, fused_spmv_plain, lower_fused  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    compile_spmv,
    matrix_fingerprint,
    prepare,
)
from repro_torch.kernels.sell import sell_spmv, sell_spmv_plain  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    BlockPlan,
    CompositePlan,
    compile_fused_partitioned,
    compile_partitioned,
    partition_rows,
)
from repro_torch.sparse.generate import SUITE, generate_by_name, random_matrix  # noqa: E402
from repro_torch.sparse.registry import format_names, unregister_format  # noqa: E402
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

WRAPPERS = {"csr": csr_spmv, "ell": ell_spmv, "sell": sell_spmv, "bell": bell_spmv,
            "fused": fused_spmv, "bcsr": bcsr_spmv}
BLOCK_FORMATS = ("csr", "ell", "sell", "bell", "bcsr")  # one wrapper each
KERNEL_ORDER = ("csr", "ell", "sell", "bell", "fused", "bcsr")
REPLACES = {
    "csr": "src/repro/kernels/csr.py:48",
    "ell": "src/repro/kernels/ell.py:45",
    "sell": "src/repro/kernels/sell.py:54",
    "bell": "src/repro/kernels/bell.py:40",
    "fused": "src/repro/kernels/fused.py:154",
    "bcsr": "src/repro/sparse/bcsr.py:208",
}
# matrix each kernel is checked and timed on: one the served path gives it
CHECK_MATRIX = {"csr": "human_gene2", "ell": "rim", "sell": "rim", "bell": BELL_MATRIX,
                "fused": "hetero", "bcsr": BELL_MATRIX}

# partitioned phase: three pool matrices and the heterogeneous one
PART_POOL = ("human_gene2", "rim", "amazon0601", "hetero")
N_PART_REQUESTS = 8  # per executor
MAX_BLOCKS = 8
# The forced heterogeneous plan: hetero at k = 4 with the reference test's
# four formats round-robin, rotated so BELL lands on a dense-band block. The
# nnz balance puts the whole power-law half (~8,500 rows) into the last
# block, and BELL's storage guard (~8 bytes per element of rows x columns)
# refuses any block above ~4,800 rows at 14,000 columns.
FORCED_FORMATS = ("ell", "sell", "bell", "csr")
PLUGIN_FORMATS = ("bcsr", "ell", "bell", "csr")  # a BCSR block: the to_dense route
_ZERO = ObjectiveValues(0.0, 0.0, 0.0, 0.0)


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


def make_hetero() -> np.ndarray:
    """n = 14,000: the top half of a 64-wide dense band stacked on the bottom
    half of a power-law matrix (the shape of the reference tests'
    ``hetero_matrix``, with a band narrow enough to hold dense on the host)."""
    top = random_matrix(N_TARGET, 64, "denseband", seed=1)[: N_TARGET // 2]
    bot = random_matrix(N_TARGET, 3.0, "powerlaw", seed=2)[N_TARGET // 2 :]
    return np.vstack([top, bot]).astype(np.float32)


def forced_plan(dense: np.ndarray, fmts, k: int, schedule: KernelSchedule) -> CompositePlan:
    """A CompositePlan with formats assigned round-robin over ``k`` blocks,
    as the reference's fused tests force it: exercises lowering, not planning."""
    part = partition_rows(dense, k)
    blocks = tuple(
        BlockPlan(b, fmts[i % len(fmts)], schedule, _ZERO, fmts[i % len(fmts)])
        for i, b in enumerate(part.blocks)
    )
    return CompositePlan("latency", part, blocks, _ZERO, _ZERO, fmts[0], schedule)


def prepared(fmt: str, dense: np.ndarray, schedule: KernelSchedule):
    """The storage a kernel is checked on, as the served path prepares it."""
    if fmt == "fused":
        plan = forced_plan(dense, FORCED_FORMATS, 4, schedule)
        return lower_fused(dense, plan, device=DEVICE)
    if fmt == "bcsr":
        from repro_torch.sparse.bcsr import BCSR_SPEC

        return BCSR_SPEC.prepare(dense, schedule, device=DEVICE)
    return prepare(dense, fmt, schedule, device=DEVICE)


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict[str, int]:
    return {k: w.launches for k, w in WRAPPERS.items()}


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
    if fmt == "bcsr":
        n_cols = mat.shape[1]
        xp = torch.zeros(ceil_to(n_cols, mat.bc), dtype=x.dtype, device=x.device)
        xp[:n_cols] = x
        panels = xp.reshape(-1, mat.bc)
        args = (mat.data, mat.block_cols, mat.block_rows, mat.block_ptr, panels, schedule)
        nb = mat.n_blocks  # the kernel reads the real blocks only
        ins = (mat.data[:nb], mat.block_cols[:nb], mat.block_ptr, panels)
        fl = 2 * nb * mat.br * mat.bc
        return ((lambda: bcsr_spmv(*args)), (lambda: bcsr_spmv_plain(*args)), ins,
                mat.n_block_rows * mat.br, fl)
    if fmt == "fused":
        args = (mat.data, mat.cols, mat.rows, mat.tile_map, x, mat.n_rows, mat.tile)
        kw = dict(unroll=mat.unroll, accum_dtype=mat.accum_dtype)
        ins = (mat.data, mat.cols, mat.rows, mat.tile_map, x)
        fl = 2 * int((mat.rows < mat.n_rows).sum())  # real entries, not padding
        return ((lambda: fused_spmv(*args, **kw)), (lambda: fused_spmv_plain(*args, **kw)),
                ins, mat.n_rows + 1, fl)
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
        mat = prepared(fmt, dense, sched)
        kern, plain, ins, out_elems, flops = kernel_calls(fmt, mat, x, sched)
        y_k = kern()
        torch.cuda.synchronize()  # a fault during the run surfaces here
        y_p = plain()
        yk = y_k.reshape(-1)[:n_rows].cpu().numpy()
        yp = y_p.reshape(-1)[:n_rows].cpu().numpy()
        err = scaled_err(yk, yp)
        err_host = scaled_err(yk, ref64)
        tol = 3e-2 if getattr(mat, "accum_dtype", sched.accum_dtype) == "bfloat16" else tol_of(sched)
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
            library_call(fmt, dense, mat, x, ref64, entry)
        del mat
    entry["max_abs_err"] = worst
    entry["tolerance"] = {"float32": 1e-4, "bfloat16": 3e-2}
    entry["by_schedule"] = per_schedule
    return entry


def library_call(fmt: str, dense: np.ndarray, mat, x: torch.Tensor, ref64, entry: dict) -> None:
    """Time one PyTorch call that computes the same y = A x, where there is
    one: a CSR product (also for the fused stream, whose function is the
    whole matrix's product) or a BSR product of the BCSR blocks. A refusal
    by PyTorch is recorded in place of the time."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR/BSR is beta" notices
        if fmt in ("csr", "fused"):
            csr = mat if fmt == "csr" else prepare(dense, "csr", device=DEVICE)
            a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, device=DEVICE)
            call = lambda: a @ x  # noqa: E731
        elif fmt == "bcsr":
            nb, (n_rows, n_cols) = mat.n_blocks, mat.shape
            xp = torch.zeros(ceil_to(n_cols, mat.bc), 1, device=DEVICE)
            xp[:n_cols, 0] = x
            try:
                a = torch.sparse_bsr_tensor(
                    mat.block_ptr, mat.block_cols[:nb], mat.data[:nb],
                    size=(mat.n_block_rows * mat.br, xp.shape[0]), device=DEVICE)
                call = lambda: (a @ xp)[:n_rows, 0]  # noqa: E731
                call()
            except Exception as exc:  # PyTorch refuses: recorded, not hidden
                entry["library_error"] = f"{type(exc).__name__}: {exc}"[:300]
                return
        else:
            return
        y_l = call().cpu().numpy()
    entry["library_err"] = scaled_err(y_l, ref64)
    entry["library_ms"] = timed(call)


# ------------------------------------------------------------ partitioned
def cache_entry(session, dense, objective="latency"):
    """The session's cached partitioned plan for ``dense`` (bucket level)."""
    bucket = session.cache.bucket_of(extract_features(dense))
    return session.cache.peek(bucket, objective, f"part:max{MAX_BLOCKS}")


def serve_partitioned_requests(session, server, part_pool, names, xs, fused: bool):
    """One request per ``server.run`` call, so each request's span seconds
    are read off the tracer as the difference around its call."""
    from repro_torch.obs.trace import get_tracer

    rows, blocks_served = [], {f: 0 for f in BLOCK_FORMATS}
    tracer = get_tracer()
    for rid, (n, x) in enumerate(zip(names, xs)):
        dense = part_pool[n]
        before = {k: v["total_s"] for k, v in tracer.summary()["by_name"].items()}
        t0 = time.perf_counter()
        (req,) = server.run([SpmvRequest(rid=rid, dense=dense, x=x, objective="latency")])
        wall = time.perf_counter() - t0
        after = tracer.summary()["by_name"]
        spans = {k: v["total_s"] - before.get(k, 0.0) for k, v in after.items()
                 if v["total_s"] - before.get(k, 0.0) > 0}
        entry = cache_entry(session, dense)
        bf16 = [b["schedule"]["accum_dtype"] == "bfloat16" for b in entry.blocks]
        # fused: bf16 only when every block asked for it; sequential: any block
        tol = 3e-2 if (all(bf16) if fused else any(bf16)) else 1e-4
        ref = host_product(dense, x)
        err = scaled_err(req.y, ref)
        formats = req.fmt.split("+")
        mono = entry.predicted.get("monolithic_latency", 0.0)
        gain = (mono - entry.predicted["latency"]) / mono if mono else 0.0
        bell_blocks = [(b["row_start"], b["row_end"]) for b in entry.blocks if b["fmt"] == "bell"]
        for f in formats:
            blocks_served[f] += 1
        rows.append({"rid": rid, "matrix": n, "k": len(formats), "formats": formats,
                     "modeled_gain": gain, "hit": req.cache_hit, "err": err, "tol": tol,
                     "wall_s": wall, "request_s": req.latency_s, "spans": spans,
                     "bell_blocks": bell_blocks})
        if not (req.y.shape == ref.shape and np.isfinite(req.y).all() and err <= tol):
            raise AssertionError(f"partitioned request {rid} ({n}, fused={fused}) wrong: "
                                 f"err {err:.3e} > {tol:.0e}")
    return rows, blocks_served


def run_forced(dense: np.ndarray, fmts, x: np.ndarray) -> dict:
    """A forced four-block plan through both executors: fused against
    sequential against the float64 host product."""
    plan = forced_plan(dense, fmts, 4, DEFAULT_SCHEDULE)
    seq = compile_partitioned(dense, plan, device=DEVICE)
    fused = compile_fused_partitioned(dense, plan, device=DEVICE)
    y_seq = seq(x).cpu().numpy()
    y_fused = fused(x).cpu().numpy()
    ref = host_product(dense, x)
    out = {"formats": list(plan.formats),
           "blocks": [(bp.block.row_start, bp.block.row_end) for bp in plan.blocks],
           "tiles": fused.n_tiles, "tile": fused.kernel.tile,
           "err_sequential": scaled_err(y_seq, ref), "err_fused": scaled_err(y_fused, ref),
           "fused_vs_sequential": scaled_err(y_fused, y_seq)}
    if not (np.isfinite(y_fused).all() and max(out["err_sequential"], out["err_fused"],
                                               out["fused_vs_sequential"]) <= 1e-4):
        raise AssertionError(f"forced plan {fmts} wrong: {out}")
    return out


def time_composites(session, part_pool, fps, x_of) -> dict:
    """Per served matrix, the composite's device time by CUDA events: the
    sequential executor (k launches and the concatenation) against the fused
    one (one launch), beside the fused stream's byte bound. Plans and
    kernels come from the session's caches (hits); these launches are
    timing, not the main path, and are not counted."""
    out = {}
    for n, dense in part_pool.items():
        x = torch.as_tensor(x_of[n], device=DEVICE)
        seq, fused = (session.partitioned_optimize(dense, max_blocks=MAX_BLOCKS, fused=f,
                                                   fingerprint=fps[n]) for f in (False, True))
        f = fused.kernel.kernel
        nnz = int((f.rows < f.n_rows).sum())
        bound_ms, bound_by, nbytes = bound((f.data, f.cols, f.rows, f.tile_map, x),
                                           f.n_rows + 1, 2 * nnz)
        out[n] = {"k": fused.n_blocks, "formats": list(fused.plan.formats),
                  "stream_entries": int(f.data.shape[0]), "nnz": nnz, "tiles": f.n_tiles,
                  "tile": f.tile, "unroll": f.unroll, "accum": f.accum_dtype,
                  "sequential_ms": timed(lambda: seq.kernel(x)),
                  "fused_ms": timed(lambda: fused.kernel(x)),
                  "fused_bound_ms": bound_ms, "bound_by": bound_by, "fused_bytes": nbytes}
    return out


def check_launches(phase: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{phase}: launches (got, want) differ: {bad}")


# -------------------------------------------------------------------- main
def main() -> None:
    t_all = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc_version = run([kbuild.find_nvcc(), "--version"]).splitlines()[-2:]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc_version, card=smi,
         device=torch.cuda.get_device_name(0))

    built = kbuild.build_all()
    ptxas = {n: [{"kernel": k["function"][:60], "registers": k["registers"],
                  "spill_bytes": k["spill_bytes"]} for k in kbuild.ptxas_usage(log)]
             for n, log in built["log"].items()}
    emit("build", seconds=built["seconds"], built=built["built"],
         dir=os.path.relpath(str(kbuild.build_dir()), HERE), ptxas=ptxas)
    registers = {n: sorted({k["registers"] for k in ks}) for n, ks in ptxas.items()}

    t0 = time.perf_counter()
    pool = make_pool()
    extra = {BELL_MATRIX: make_bell_matrix(), "hetero": make_hetero()}
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
    # the BCSR storage is checked through its FormatSpec directly; the format
    # is registered only in phase 7, so phases 4-6 decide as before
    import repro_torch.sparse.bcsr as bcsr_plugin

    unregister_format("bcsr")
    for fmt in KERNEL_ORDER:
        name = CHECK_MATRIX[fmt]
        sched = csr_schedule if fmt == "csr" else DEFAULT_SCHEDULE
        checked[fmt] = check_kernel(fmt, name, {**pool, **extra}[name], sched)
        checked[fmt]["registers"] = registers.get(f"spmv_{fmt}")
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
    reset_launches()
    t0 = time.perf_counter()
    server.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
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
    reset_launches()
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
    rt_launches = read_launches()
    for k in launches:
        launches[k] += rt_launches[k]
    emit("runtime_mode", seconds=time.perf_counter() - t0, decisions=decisions,
         direct=direct, launches=rt_launches, session=session.stats.as_dict())

    # ---- partitioned: sequential and fused composite serving --------------
    t0 = time.perf_counter()
    part_pool = {n: extra[n] if n == "hetero" else pool[n] for n in PART_POOL}
    rng = np.random.default_rng(SEED + 2)
    # every matrix once, then repeats
    names = list(PART_POOL) + [str(rng.choice(PART_POOL))
                               for _ in range(N_PART_REQUESTS - len(PART_POOL))]
    xs = [rng.normal(size=part_pool[n].shape[1]).astype(np.float32) for n in names]
    x_of = dict(zip(names, xs))  # one vector per matrix for the forced runs and timings
    part_session = AutoSpmvSession(tuner)
    phase_launches = {}
    results = {}
    for fused in (False, True):
        server = SpmvServer(part_session, partition=True, max_blocks=MAX_BLOCKS, fused=fused)
        reset_launches()
        rows, blocks_served = serve_partitioned_requests(
            part_session, server, part_pool, names, xs, fused)
        torch.cuda.synchronize()
        got = read_launches()
        want = ({**{f: 0 for f in BLOCK_FORMATS}, "fused": N_PART_REQUESTS} if fused
                else {**blocks_served, "fused": 0})
        check_launches(f"partitioned(fused={fused})", got, want)
        results["fused" if fused else "sequential"] = rows
        phase_launches["fused" if fused else "sequential"] = got
    reset_launches()
    forced = run_forced(part_pool["hetero"], FORCED_FORMATS, x_of["hetero"])
    torch.cuda.synchronize()
    got = read_launches()
    check_launches("partitioned(forced)", got, {
        "fused": 1, **{f: FORCED_FORMATS.count(f) for f in BLOCK_FORMATS}})
    phase_launches["forced"] = got
    for got in phase_launches.values():
        for k in launches:
            launches[k] += got[k]
    part_stats = part_session.stats.as_dict()
    fps["hetero"] = matrix_fingerprint(part_pool["hetero"])
    composites = time_composites(part_session, part_pool, fps, x_of)
    bell_at_full_width = [
        {"rid": r["rid"], "matrix": r["matrix"], "rows": r["bell_blocks"]}
        for r in results["sequential"] if r["bell_blocks"]]
    emit("partitioned", seconds=time.perf_counter() - t0, requests=results,
         forced=forced, bell_blocks=bell_at_full_width, launches=phase_launches,
         session=part_stats, composites=composites)

    # ---- plugin: BCSR registered, run-time mode, direct, forced plan ------
    t0 = time.perf_counter()
    bcsr_plugin.register()
    # importing the plugin is the whole integration: a tuner built now has
    # BCSR in its tuning space, dataset and format classifier
    plug_session = AutoSpmvSession(build_tuner())
    reset_launches()
    plug_decisions = []
    for n, dense in pool.items():
        for obj in OBJECTIVES:
            try:
                res = plug_session.run_time_optimize(dense, obj, n_iterations=10_000,
                                                     fingerprint=fps[n])
            except InfeasibleConfig as exc:
                plug_decisions.append({"matrix": n, "objective": obj, "infeasible": str(exc)})
                continue
            row = {"matrix": n, "objective": obj, "format": res.best_format,
                   "convert": res.convert}
            if res.kernel is not None:
                x = rng.normal(size=dense.shape[1]).astype(np.float32)
                row["err"] = scaled_err(res.kernel(x).cpu().numpy(), host_product(dense, x))
                if row["err"] > tol_of(res.kernel.schedule):
                    raise AssertionError(f"run-time kernel wrong with BCSR registered: {row}")
            plug_decisions.append(row)
    plug_direct = []
    for n in (BELL_MATRIX, "pkustk04", "human_gene2"):
        dense = {**pool, **extra}[n]
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        try:
            kernel = compile_spmv(dense, "bcsr", DEFAULT_SCHEDULE, device=DEVICE)
        except InfeasibleConfig as exc:
            if n == BELL_MATRIX:
                raise
            # like BELL, the guard refuses BCSR at n ~ 14,000: reported, not hidden
            plug_direct.append({"format": "bcsr", "matrix": n, "infeasible": str(exc)})
            continue
        err = scaled_err(kernel(x).cpu().numpy(), host_product(dense, x))
        plug_direct.append({"format": "bcsr", "matrix": n, "err": err})
        if err > 1e-4:
            raise AssertionError(f"compile_spmv(bcsr) on {n} wrong: err {err:.3e}")
        del kernel
    plug_forced = run_forced(extra["hetero"], PLUGIN_FORMATS, x_of["hetero"])
    torch.cuda.synchronize()
    got = read_launches()
    if got["fused"] != 1 or got["bcsr"] < 2:
        raise AssertionError(f"plugin: fused/bcsr launches {got}")
    for k in launches:
        launches[k] += got[k]
    registry = format_names()
    unregister_format("bcsr")
    emit("plugin", seconds=time.perf_counter() - t0, registry=list(registry),
         bcsr_wins=[d for d in plug_decisions if d.get("format") == "bcsr"],
         decisions=plug_decisions, direct=plug_direct, forced=plug_forced,
         launches=got)

    missing = [k for k in KERNEL_ORDER if launches[k] <= 0]
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
        for fmt in KERNEL_ORDER
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
