#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``): the quickest
proof that the port builds, launches and serves on an NVIDIA Hopper card.

Run it from the root of a checkout, with no arguments, on a machine with one
CUDA device, ``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py

It imports ``repro_torch`` only (never JAX, never the JAX package) and needs
no network. Phases, each printing one JSON object on a line of its own:

1. ``env``      torch / CUDA / nvcc versions, card name and power limit.
2. ``build``    compiles ``src/repro_torch/csrc/*.cu`` (seven sources) for
                sm_90a (one ``nvcc`` per source, in parallel) and reports the
                seconds and each kernel's registers and spills (ptxas).
3. ``check``    every hand-written kernel against its plain PyTorch version
                and a float64 host product on the card, over six schedules,
                at the shapes the served path gives it; a disagreement beyond
                the stated tolerance raises. Also times kernel, plain version
                and, where one PyTorch call computes the same function, that
                call. The fused kernel runs on the stream ``lower_fused``
                makes from a forced four-block plan of ``hetero``, the BCSR
                kernel on ``pkustk04`` at n = 8,000, the SpMSpV kernel on the
                ``CscEll`` of ``webgraph`` at n = 14,011 for five frontiers
                (its largest column, 1 %, 10 % and 50 % of the columns, all
                of them), each beside the library's CSR product and the CSR
                kernel on the same matrix and x.
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
8. ``solve``    the iterative solvers on a fresh session: PageRank on
                ``webgraph`` (n = 14,011) with the uniform teleport, held
                against a float64 oracle of the same recurrence; personalised
                PageRank and power iteration (30 iterations from one seed
                vertex) under ``AdaptiveSpmvPolicy``, whose sparse frontiers
                run the SpMSpV kernel and flip one way to SpMV; CG on the SPD
                operator of ``rim`` (n ~ 14,000) to a relative residual of
                1e-6, checked in float64; and ``repro_torch.launch.solve``'s
                ``main`` in-process (power, ``--adaptive-spmspv``). SpMSpV
                launches must equal the solves' SpMSpV matvecs, CSR launches
                their SpMV matvecs. Then a host-clock breakdown of one
                iteration (copies, kernel, numpy step).

Launch counters are set to 0 just before phases 4-8 and read just after each:
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
import subprocess
import sys
import tempfile
import time
import warnings

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
from repro_torch.kernels.spmspv import (  # noqa: E402
    col_nnz,
    csc_from_dense,
    csc_spmspv,
    csc_spmspv_kernel,
    csc_spmspv_plain,
)
from repro_torch.launch import solve as launch_solve  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    BlockPlan,
    CompositePlan,
    compile_fused_partitioned,
    compile_partitioned,
    partition_rows,
)
from repro_torch.solvers import AdaptiveSpmvPolicy, cg, pagerank, power_iteration  # noqa: E402
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
            "fused": fused_spmv, "bcsr": bcsr_spmv, "spmspv": csc_spmspv}
BLOCK_FORMATS = ("csr", "ell", "sell", "bell", "bcsr")  # one wrapper each
KERNEL_ORDER = ("csr", "ell", "sell", "bell", "fused", "bcsr", "spmspv")
# the CUDA source (csrc/<name>.cu) of each kernel
SOURCE = {**{k: f"spmv_{k}" for k in KERNEL_ORDER}, "spmspv": "spmspv_csc"}
KERNEL_NAME = {**{k: f"{k}_spmv" for k in KERNEL_ORDER}, "spmspv": "csc_spmspv"}
REPLACES = {
    "csr": "src/repro/kernels/csr.py:48",
    "ell": "src/repro/kernels/ell.py:45",
    "sell": "src/repro/kernels/sell.py:54",
    "bell": "src/repro/kernels/bell.py:40",
    "fused": "src/repro/kernels/fused.py:154",
    "bcsr": "src/repro/sparse/bcsr.py:208",
    "spmspv": "src/repro/kernels/spmspv.py:145",
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

# solve phase: webgraph at the scale that gives n = 14,011 (its CscEll pads
# every column to the hub column's 3,322 nonzeros: W = 3,328 at nnz_tile 128)
WEB_SCALE = 0.016
SOLVE_TOL = {"pagerank": 1e-7, "cg": 1e-6}
POWER_ITERS = 30
CLI_SCALE = WEB_SCALE  # launch.solve builds its own tuner at this scale
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


# ------------------------------------------------------------------ spmspv
def frontiers_of(counts: np.ndarray, rng) -> list[tuple[str, np.ndarray]]:
    """The check's frontiers (sorted column indices, as a solver's
    ``flatnonzero`` gives them): the single largest column; 1 %, 10 % (the
    policy's threshold) and 50 % of the columns drawn at random; all of them."""
    n_cols = counts.size
    out = [("largest_column", np.array([int(np.argmax(counts))], np.int32))]
    for pct in (1, 10, 50):
        pick = rng.choice(n_cols, size=n_cols * pct // 100, replace=False)
        out.append((f"{pct}%", np.sort(pick).astype(np.int32)))
    out.append(("full", np.arange(n_cols, dtype=np.int32)))
    return out


def check_spmspv(web: np.ndarray, time_schedule: KernelSchedule) -> dict:
    """Hold the SpMSpV kernel against its plain version and a float64 host
    product over the six schedules and five frontiers of ``webgraph``; at
    ``time_schedule`` (the one the solver's SpMSpV twin runs) time every
    frontier beside its byte bound, the plain version, the library's CSR
    product of the same x and the CSR kernel on the same matrix and x."""
    import scipy.sparse

    rng = np.random.default_rng(SEED + 13)
    n_rows, n_cols = web.shape
    counts = col_nnz(web)
    a64 = scipy.sparse.csr_matrix(web).astype(np.float64)
    fronts = []
    for name, active in frontiers_of(counts, rng):
        xvals = rng.normal(size=active.size).astype(np.float32)
        x = np.zeros(n_cols, np.float32)
        x[active] = xvals
        fronts.append({"name": name, "active": active, "xvals": xvals, "x": x,
                       "ref64": a64 @ x.astype(np.float64)})
    csr = prepare(web, "csr", device=DEVICE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR is beta" notice
        lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape,
                                      device=DEVICE)
    schedules = list(SCHEDULES)
    if time_schedule not in schedules:
        schedules.append(time_schedule)
    mats, worst, per_schedule, timed_rows = {}, 0.0, {}, []
    t_conv = None
    for sched in schedules:
        if sched.nnz_tile not in mats:  # the storage depends on nnz_tile only
            t0 = time.perf_counter()
            mats[sched.nnz_tile] = csc_from_dense(web, sched, device=DEVICE)
            torch.cuda.synchronize()
            if sched.nnz_tile == time_schedule.nnz_tile:
                t_conv = time.perf_counter() - t0
        mat = mats[sched.nnz_tile]
        tol = tol_of(sched)
        for f in fronts:
            act = torch.as_tensor(f["active"], device=DEVICE)
            xv = torch.as_tensor(f["xvals"], device=DEVICE)
            args = (mat.data, mat.rows, act, xv, n_rows, sched)
            y_k = csc_spmspv_kernel(*args)
            torch.cuda.synchronize()  # a fault during the run surfaces here
            yk = y_k[:n_rows].cpu().numpy()
            yp = csc_spmspv_plain(*args)[:n_rows].cpu().numpy()
            err, err_host = scaled_err(yk, yp), scaled_err(yk, f["ref64"])
            if not (np.isfinite(yk).all() and err <= tol and err_host <= tol):
                raise AssertionError(
                    f"spmspv kernel disagrees on webgraph, frontier {f['name']}, {sched}: "
                    f"vs plain {err:.3e}, vs host float64 {err_host:.3e}, tolerance {tol:.0e}")
            worst = max(worst, err)
            if f["name"] == "10%":
                tag = sched_tag(sched) + ("_par" if sched.dimension_semantics == "parallel" else "")
                per_schedule[tag] = {
                    "ms": timed(lambda: csc_spmspv_kernel(*args)), "err_vs_plain": err,
                    "err_vs_host": err_host}
            if sched != time_schedule:
                continue
            k, touched = int(f["active"].size), int(counts[f["active"]].sum())
            nbytes = touched * 8 + k * 8 + (n_rows + 1) * 4  # what skipping padding must move
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * touched / FP32_FLOPS
            x_dev = torch.as_tensor(f["x"], device=DEVICE)
            y_lib = (lib @ x_dev).cpu().numpy()
            y_b1 = csr_spmv(csr.data, csr.indices, csr.indptr, x_dev, sched).cpu().numpy()
            row = {"frontier": f["name"], "k": k, "density": k / n_cols,
                   "nnz_touched": touched, "padded_slots_of_frontier": k * mat.width,
                   "ms": timed(lambda: csc_spmspv_kernel(*args)),
                   "plain_ms": timed(lambda: csc_spmspv_plain(*args), reps=5),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                   "library_ms": timed(lambda: lib @ x_dev),
                   "library_err": scaled_err(y_lib, f["ref64"]),
                   "b1_ms": timed(lambda: csr_spmv(csr.data, csr.indices, csr.indptr, x_dev,
                                                   sched)),
                   "b1_err": scaled_err(y_b1, f["ref64"]),
                   "err_vs_plain": err, "err_vs_host": err_host}
            if max(row["library_err"], row["b1_err"]) > 1e-4:
                raise AssertionError(f"library or CSR product wrong on webgraph: {row}")
            timed_rows.append(row)
    head = next(r for r in timed_rows if r["frontier"] == "10%")
    mat = mats[time_schedule.nnz_tile]
    entry = {
        "matrix": f"webgraph@{n_rows}",
        "shape": [n_rows, n_cols],
        "nnz": int(counts.sum()),
        "schedule": sched_tag(time_schedule),
        "frontier": "10%",
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                                "library_ms", "b1_ms")},
        "library": "torch.sparse_csr_tensor(A) @ x (x dense, the frontier's values)",
        "cscell": {"width": mat.width, "nbytes": mat.nbytes, "max_col_nnz": int(counts.max()),
                   "dangling_columns": int((counts == 0).sum()),
                   "conversion_and_copy_s": t_conv},
        "frontiers": timed_rows,
        "max_abs_err": worst,
        "tolerance": {"float32": 1e-4, "bfloat16": 3e-2},
        "by_schedule": per_schedule,
    }
    del mats, lib, csr
    return entry


# ------------------------------------------------------------------- solve
def pagerank_oracle(web: np.ndarray, v: np.ndarray, damping: float = 0.85,
                    tol: float = 1e-13, max_iters: int = 2000) -> np.ndarray:
    """The solvers' PageRank recurrence in float64 on the host, with
    ``scipy.sparse`` (the dense float64 operator would take 1.6 GB)."""
    import scipy.sparse

    a = scipy.sparse.csr_matrix(web).astype(np.float64)
    sums = np.asarray(a.sum(axis=0)).ravel()
    p = (a @ scipy.sparse.diags(np.where(sums > 0, 1.0 / np.where(sums > 0, sums, 1.0), 0.0)))
    p = p.tocsr()
    dangling = sums == 0
    v = v.astype(np.float64) / v.sum()
    r = v.copy()
    for _ in range(max_iters):
        r_next = damping * (p @ r + r[dangling].sum() * v) + (1.0 - damping) * v
        if np.abs(r_next - r).sum() <= tol:
            return r_next
        r = r_next
    return r


def solve_row(res, policy=None) -> dict:
    """What the solve phase prints per solve."""
    kinds = np.array(res.matvec_kinds)
    secs = np.array(res.matvec_seconds)
    p50 = {k: 1e3 * float(np.median(secs[kinds == k])) for k in ("spmv", "spmspv")
           if (kinds == k).any()}
    row = {"solver": res.solver, "iterations": res.iterations, "converged": res.converged,
           "residual": res.residual, "spmv_calls": res.spmv_calls,
           "spmspv_calls": res.spmspv_calls, "matvec_p50_ms": p50,
           "iter_p50_ms": 1e3 * res.iter_p50_s(), "modeled_work": res.modeled_work,
           "spmv_work_equiv": res.spmv_work_equiv,
           "work_ratio": res.modeled_work / max(res.spmv_work_equiv, 1),
           "plan_id": res.plan_id, "fmt": res.fmt, "cache_hit": res.cache_hit,
           "kinds": "".join("S" if k == "spmspv" else "." for k in res.matvec_kinds)}
    if policy is not None:
        row["densities"] = [d.density for d in policy.decisions]
    return row


def span_seconds(spans: list[dict]) -> dict:
    """Seconds by span name, ``kernel.compile`` split by its fmt."""
    out: dict[str, float] = {}
    for s in spans:
        name = s["name"]
        if name == "kernel.compile":
            name += ":" + str(s["attrs"].get("fmt", s["attrs"].get("formats", "?")))
        out[name] = out.get(name, 0.0) + s["dur_s"]
    return out


def one_flip(kinds: list[str]) -> bool:
    """SpMSpV first, then SpMV for good."""
    if not kinds or kinds[0] != "spmspv" or "spmv" not in kinds:
        return False
    flip = kinds.index("spmv")
    return all(k == "spmspv" for k in kinds[:flip]) and all(k == "spmv" for k in kinds[flip:])


def host_ms(fn, reps: int = 30) -> float:
    """Median host-clock ms of ``fn`` followed by a device synchronise."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(out))


def iteration_breakdown(session, web: np.ndarray, power_res, policy) -> dict:
    """Host-clock split of one power-iteration step on ``webgraph``: the
    numpy step, the copies and the kernel call (launch + wait), for an SpMV
    iteration and for an SpMSpV one at the 10 % frontier. Kernels and plans
    come from the session's memo (hits). Run after the solve phase's
    launches are read: these launches are timing, not the main path."""
    from repro_torch.solvers.iterate import IterativeSolver

    solver = IterativeSolver(session, web, name="breakdown", policy=policy)
    solver.setup()
    spmv_k, spmspv_k = solver._spmv_kernel, solver._ensure_spmspv()
    n = web.shape[1]
    rng = np.random.default_rng(SEED + 21)
    x = rng.normal(size=n).astype(np.float32)
    act = np.sort(rng.choice(n, size=n // 10, replace=False)).astype(np.int32)
    xv = x[act]
    x_dev = torch.as_tensor(x, device=DEVICE)
    act_dev, xv_dev = torch.as_tensor(act, device=DEVICE), torch.as_tensor(xv, device=DEVICE)
    y_dev = spmv_k(x_dev)
    mat = spmspv_k.mat
    y = y_dev.cpu().numpy().astype(np.float64)
    xs = x.astype(np.float64)

    def numpy_step():  # power iteration's host work on one y
        lam = float(xs @ y)
        nv = float(np.linalg.norm(y))
        xn = y / nv
        xn = np.where(np.abs(xn) >= 1e-7, xn, 0.0)
        xn = xn / (float(np.linalg.norm(xn)) or 1.0)
        float(np.linalg.norm(y - lam * xs))
        np.flatnonzero(xn.astype(np.float32))

    step_s = []
    for _ in range(30):
        t0 = time.perf_counter()
        numpy_step()
        step_s.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(step_s))
    return {
        "spmv": {"h2d_x_ms": host_ms(lambda: torch.as_tensor(x, device=DEVICE)),
                 "kernel_call_ms": host_ms(lambda: spmv_k(x_dev)),
                 "d2h_y_ms": host_ms(lambda: y_dev.cpu()),
                 "matvec_ms": host_ms(lambda: solver.matvec(x))},
        "spmspv_10pct": {
            "h2d_frontier_ms": host_ms(lambda: (torch.from_numpy(act).to(DEVICE),
                                                torch.from_numpy(xv).to(DEVICE))),
            "kernel_call_ms": host_ms(lambda: csc_spmspv_kernel(
                mat.data, mat.rows, act_dev, xv_dev, mat.shape[0], spmspv_k.schedule)),
            "wrapper_ms": host_ms(lambda: spmspv_k.call_frontier(act, xv)),
        },
        "numpy_step_ms": step_ms,
        "power_matvec_p50_ms": solve_row(power_res)["matvec_p50_ms"],
        "power_iter_p50_ms": 1e3 * power_res.iter_p50_s(),
    }


def run_solve_phase(tuner, web: np.ndarray, rim: np.ndarray) -> tuple[dict, dict]:
    """The solvers through the public entry points; returns (payload, launches)."""
    from repro_torch.obs.trace import get_tracer

    tracer = get_tracer()
    tracer.clear()
    session = AutoSpmvSession(tuner)
    n = web.shape[0]
    rows, oracle = {}, {}
    reset_launches()

    def traced(name, fn, policy=None):
        before = len(tracer.spans())
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        row = solve_row(res, policy)
        row["wall_s"] = time.perf_counter() - t0
        row["spans"] = span_seconds(tracer.spans()[before:])
        row["session"] = session.stats.as_dict()
        rows[name] = row
        return res

    uniform = traced("pagerank", lambda: pagerank(
        session, web, tol=SOLVE_TOL["pagerank"], max_iters=200))
    r64 = pagerank_oracle(web, np.full(n, 1.0 / n))
    oracle["pagerank"] = float(np.abs(uniform.value - r64).max())
    seed = int(np.flatnonzero(col_nnz(web) > 0)[0])
    pers = np.zeros(n, np.float32)
    pers[seed] = 1.0
    pol_pr = AdaptiveSpmvPolicy()
    personal = traced("pagerank_personalised", lambda: pagerank(
        session, web, tol=SOLVE_TOL["pagerank"], max_iters=200, policy=pol_pr,
        personalization=pers), pol_pr)
    oracle["pagerank_personalised"] = float(
        np.abs(personal.value - pagerank_oracle(web, pers.astype(np.float64))).max())
    pol_pw = AdaptiveSpmvPolicy()
    power = traced("power", lambda: power_iteration(
        session, web, tol=0.0, max_iters=POWER_ITERS, policy=pol_pw), pol_pw)
    spd = launch_solve.spd_operator(rim)
    b = np.random.default_rng(SEED + 5).standard_normal(spd.shape[0]).astype(np.float32)
    cg_res = traced("cg", lambda: cg(session, spd, b, tol=SOLVE_TOL["cg"], max_iters=200))
    import scipy.sparse

    s64 = scipy.sparse.csr_matrix(spd).astype(np.float64)
    cg_rel = float(np.linalg.norm(b - s64 @ cg_res.value) / np.linalg.norm(b))
    del spd, s64

    # the CLI, in-process, with its own tuner (timed around its build_tuner)
    tuner_s = []
    build = launch_solve.build_tuner

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        tuner_s.append(time.perf_counter() - t0)
        return out

    launch_solve.build_tuner = timed_build
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "solve.json")
            t0 = time.perf_counter()
            cli_res = launch_solve.main(["--solver", "power", "--matrix", "webgraph",
                                      "--scale", str(CLI_SCALE), "--adaptive-spmspv",
                                      "--max-iters", str(POWER_ITERS), "--tol", "0",
                                      "--json-out", out])
            torch.cuda.synchronize()
            cli_wall = time.perf_counter() - t0
            with open(out) as fh:
                cli_json = json.load(fh)
    finally:
        launch_solve.build_tuner = build
    launches = read_launches()

    results = [uniform, personal, power, cg_res, cli_res]
    want_spmspv = sum(r.spmspv_calls for r in results)
    want_spmv = sum(r.spmv_calls for r in results)
    checks = {
        "pagerank_oracle_max_abs": oracle,
        "pagerank_rank_sum": [uniform.extras["rank_sum"], personal.extras["rank_sum"]],
        "power_one_way_flip": one_flip(power.matvec_kinds),
        "power_spmspv_calls": power.spmspv_calls,
        "cg_relative_residual_float64": cg_rel,
        "cli_spmspv_calls": cli_json["spmspv_calls"], "cli_spmv_calls": cli_json["spmv_calls"],
        "spmspv_launches": launches["spmspv"], "want_spmspv": want_spmspv,
        "csr_launches": launches["csr"], "want_csr": want_spmv,
    }
    payload = {"solves": rows, "checks": checks,
               "cli": {"wall_s": cli_wall, "tuner_s": tuner_s, "scale": CLI_SCALE,
                       "n": cli_json["n"], "iterations": cli_json["iterations"],
                       "spmv_calls": cli_json["spmv_calls"],
                       "spmspv_calls": cli_json["spmspv_calls"],
                       "iter_p50_ms": 1e3 * cli_json["iter_p50_s"],
                       "kinds": solve_row(cli_res)["kinds"], "session": cli_json["session"]},
               "session": session.stats.as_dict(), "launches": launches}
    bad = []
    if max(oracle.values()) > 1e-5:
        bad.append("pagerank differs from its float64 oracle")
    if max(abs(s - 1.0) for s in checks["pagerank_rank_sum"]) > 1e-5:
        bad.append("rank sum off 1")
    if not (uniform.converged and personal.converged and cg_res.converged):
        bad.append("a solve did not converge")
    if personal.spmspv_calls < 1 or not checks["power_one_way_flip"]:
        bad.append("the adaptive solves did not route SpMSpV then SpMV one way")
    if not power.modeled_work < power.spmv_work_equiv:
        bad.append("power iteration touched no less work than SpMV")
    if cg_rel > 1e-5:
        bad.append("CG relative residual above 1e-5")
    if not (cli_json["spmspv_calls"] > 0 and cli_json["spmv_calls"] > 0):
        bad.append("the CLI did not use both paths")
    if launches["spmspv"] != want_spmspv or launches["csr"] != want_spmv:
        bad.append("launches differ from the solves' matvecs")
    if session.stats.plans_computed > 3 or session.stats.plans_computed < 1:
        bad.append("more than one plan per unique matrix")  # P of web, web, spd(rim)
    if any(np.isnan(r.residual) for r in results):
        bad.append("a NaN residual")
    if bad:
        raise AssertionError(f"solve phase: {bad}: {checks}")
    payload["breakdown"] = iteration_breakdown(session, web, power, AdaptiveSpmvPolicy())
    return payload, launches


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
    extra = {BELL_MATRIX: make_bell_matrix(), "hetero": make_hetero(),
             "webgraph": generate_by_name("webgraph", scale=WEB_SCALE)}
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
    # ... and the one the solvers' iterations run on webgraph (fp32 forced)
    web_schedule = tuner.plan_compile_time(
        extract_features(extra["webgraph"]), "latency"
    ).schedule.replace(accum_dtype="float32")
    t0 = time.perf_counter()
    checked = {}
    # the BCSR storage is checked through its FormatSpec directly; the format
    # is registered only in phase 7, so phases 4-6 decide as before
    import repro_torch.sparse.bcsr as bcsr_plugin

    unregister_format("bcsr")
    for fmt in KERNEL_ORDER:
        if fmt == "spmspv":
            checked[fmt] = check_spmspv(extra["webgraph"], web_schedule)
        else:
            name = CHECK_MATRIX[fmt]
            sched = csr_schedule if fmt == "csr" else DEFAULT_SCHEDULE
            checked[fmt] = check_kernel(fmt, name, {**pool, **extra}[name], sched)
        checked[fmt]["registers"] = registers.get(SOURCE[fmt])
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

    # ---- solve: the iterative solvers, SpMV <-> SpMSpV (B1 and B6) --------
    t0 = time.perf_counter()
    solved, got = run_solve_phase(tuner, extra["webgraph"], pool["rim"])
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("solve", seconds=time.perf_counter() - t0, **solved)

    missing = [k for k in KERNEL_ORDER if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    kernels = [
        {
            "name": KERNEL_NAME[fmt],
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCE[fmt]}.cu",
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
