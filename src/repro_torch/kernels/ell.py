"""ELL SpMV and SpMM: CUDA kernel wrappers + their plain PyTorch versions.

``ell_spmv`` computes ``y[r] = sum_k data[r, k] * x[cols[r, k]]`` over
row-major ``(R, W)`` planes whose padding slots hold value 0 / column 0. On
a CUDA tensor it launches ``csrc/spmv_ell.cu`` or raises; on a CPU tensor —
and only then — it takes ``ell_spmv_plain``. Shapes must be tile-aligned as
for the reference kernel: ``R % rows_per_block == 0`` and ``W % nnz_tile ==
0``. Its launch comes from ``ell_launch_plan`` (shapes and the card's SM
count only): a group of ``lanes`` lanes owns a row and reads
``lanes * unroll`` consecutive slots of it per step, each lane with
``unroll`` accumulators; ``rows_per_block`` and ``nnz_tile`` only align the
planes.

``ell_spmm`` is the multi-vector form over the same planes,
``Y[r, j] = sum_k data[r, k] * X[cols[r, k], j]`` with a row-major dense
``X: (n_cols, k)``; it launches ``csrc/spmm_ell.cu`` on a CUDA tensor and
takes ``ell_spmm_plain`` on a CPU one. Its launch comes from
``spmm_launch_plan`` (shapes and the card's SM count only): lanes own
output columns (groups of ``lanes`` lanes per slot, ``vec`` columns each),
several warps share a row where R alone would leave the SMs short of
warps, and a warp works on several rows where R exceeds what the card
holds at once. ``rows_per_block`` and ``nnz_tile`` only align the planes;
``schedule.unroll`` is not read, as in the reference's SpMM kernel.

Precondition of both kernels (not of the plain versions): each row stores
its nonzeros first and its padding (value 0, column 0) after, as
``ell_from_dense`` writes them. The SpMV kernel stops after the step that
holds a row's first zero value, the SpMM kernel after the 32-slot chunk
that holds it (``ell_live_width`` is the rule's host twin); neither gathers
x (an X row) for a padding slot, so each differs from summing every slot
only where ``x[0]`` (``X[0]``) holds a non-finite value.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand, sm_count

# B2's launch (csrc/spmv_ell.cu): a group of G lanes per row, a CTA of 8
# warps; the kernel's ``spmv_ell_constants`` returns the warps per CTA, and
# its entry point refuses a grid that does not cover the rows by this rule.
ELL_WARPS_PER_CTA = 8
ELL_LANE_GROUPS = (4, 8, 16, 32)  # lanes per row, each a template instance
# the most lanes per row until the grid holds this many warps per SM
ELL_TARGET_WARPS_PER_SM = 32

# B8's launch (csrc/spmm_ell.cu): a chunk is the 32 slots a warp's lanes read
# with one coalesced load each; a CTA holds 8 warps. The kernel's
# ``spmm_ell_constants`` returns these two, and its entry point refuses a
# grid that does not cover the rows by this rule.
SPMM_CHUNK = 32
SPMM_WARPS_PER_CTA = 8
SPMM_LANE_GROUPS = (1, 2, 4, 8, 16, 32)  # lanes per slot, each a template instance
SPMM_SPLIT_CHOICES = (1, 2, 4, 8)  # warps per row
# split rows across warps until R * warps_per_row reaches this many warps
# per SM: fewer leave each SM a handful of warps, each waiting on a long
# chain of dependent loads
SPMM_TARGET_WARPS_PER_SM = 16
# the most warps an SM holds (2,048 threads): beyond one wave of them a
# warp takes several rows in turn
SPMM_RESIDENT_WARPS_PER_SM = 64


def ell_spmv_plain(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """Gather, multiply, sum along the width. bf16: operands and products
    rounded to bf16, the row sum taken in float32 and rounded once."""
    xg = x[cols.long()]
    if schedule.accum_dtype == "bfloat16":
        prods = bf16_round(bf16_round(data) * bf16_round(xg))
        return bf16_round(prods.sum(dim=1)).to(x.dtype)
    return (data * xg).sum(dim=1)


def _check_planes(data, cols, operand, name: str, ndim: int, schedule: KernelSchedule):
    """The checks both ELL wrappers make: float32 ``data`` and operand,
    int32 ``cols`` on the operand's device, planes of one tile-aligned
    shape. Returns the planes' ``(R, W)``."""
    dev = operand.device
    check_operand(operand, name, torch.float32, ndim, dev)
    check_operand(data, "data", torch.float32, 2, dev)
    check_operand(cols, "cols", torch.int32, 2, dev)
    if cols.shape != data.shape:
        raise ValueError("ELL planes disagree in shape")
    R, W = data.shape
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    if R % rpb or W % nt:
        raise ValueError(f"ELL planes ({R},{W}) not aligned to ({rpb},{nt})")
    return R, W


def ell_launch_plan(R: int, W: int, n_sms: int) -> dict:
    """B2's launch from integers only: planes ``(R, W)`` and the card's SM
    count. ``lanes`` (G): the most of ``ELL_LANE_GROUPS`` while ``R * G``
    lanes stay within ``ELL_TARGET_WARPS_PER_SM`` warps per SM and G within
    the stored width; a warp holds ``32 / G`` rows, a CTA
    ``ELL_WARPS_PER_CTA`` warps."""
    R, W, n_sms = int(R), int(W), int(n_sms)
    if R < 0 or W < 0 or n_sms < 1:
        raise ValueError(f"no ELL launch for R={R}, W={W}, n_sms={n_sms}")
    G = ELL_LANE_GROUPS[0]
    for nxt in ELL_LANE_GROUPS[1:]:
        if R * nxt > ELL_TARGET_WARPS_PER_SM * 32 * n_sms or nxt > max(W, 1):
            break
        G = nxt
    return ell_grid(R, G)


def ell_grid(R: int, G: int) -> dict:
    """The plan's dict for G lanes per row: rows per warp and per CTA, CTAs
    and warps."""
    rows_per_cta = ELL_WARPS_PER_CTA * (32 // G)
    ctas = -(-R // rows_per_cta)
    return {"lanes": G, "rows_per_warp": 32 // G, "rows_per_cta": rows_per_cta,
            "ctas": ctas, "warps": ctas * ELL_WARPS_PER_CTA}


def ell_plan_choices(R: int, W: int, n_sms: int) -> list[dict]:
    """The plan first, then every other lane count."""
    plan = ell_launch_plan(R, W, n_sms)
    return [plan] + [ell_grid(R, G) for G in ELL_LANE_GROUPS if G != plan["lanes"]]


def ell_slots_read(live: torch.Tensor, W: int, plan: dict, unroll: int) -> int:
    """Plane slots B2 reads under ``plan`` for rows of ``live`` live slots:
    a row's group reads steps of ``lanes * unroll`` consecutive slots and
    stops after the step that holds the row's first padding slot, or at the
    end of the planes."""
    step = plan["lanes"] * unroll
    steps = torch.div(live, step, rounding_mode="floor") + 1
    return int(torch.clamp(steps * step, max=W).sum())


def ell_spmv(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """SpMV over padded ELL planes ``data/cols: (R, W)``; returns ``y: (R,)``.

    The kernel's precondition (the module's note): each row's nonzeros come
    before its padding. ``ell_from_dense`` writes planes so; the wrapper does
    not check planes from elsewhere, on which the kernel drops what follows
    a stored zero."""
    R, W = _check_planes(data, cols, x, "x", 1, schedule)
    dev = x.device
    if dev.type == "cpu":
        return ell_spmv_plain(data, cols, x, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"ell_spmv has no kernel for device {dev}")
    y = _ell_launch(data, cols, x, ell_launch_plan(R, W, sm_count(dev)), schedule)
    ell_spmv.launches += 1
    return y


def _ell_launch(data, cols, x, plan: dict, schedule: KernelSchedule, reads=None) -> torch.Tensor:
    """Launch B2 under ``plan`` on x's CUDA device and current stream and
    return ``y: (R,)``. ``reads``: ``None``, or an int32 tensor of
    ``plan["warps"]`` entries in which each warp writes the plane slots it
    loaded. The launch counter is the wrapper's: ``chip_smoke.py`` runs the
    plan's alternatives through here without moving it."""
    from repro_torch.kernels.build import bind, check_launch

    dev = x.device
    R, W = data.shape
    y = torch.empty((R,), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_ell", "spmv_ell_launch", [vp] * 4 + [ci] * 6 + [vp] * 2)
    with torch.cuda.device(dev):
        err = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), R, W,
                 plan["lanes"], plan["ctas"], schedule.unroll,
                 int(schedule.accum_dtype == "bfloat16"),
                 None if reads is None else reads.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "ell_spmv")
    return y


ell_spmv.launches = 0  # kernel launches made by this process


def ell_spmm_plain(
    data: torch.Tensor, cols: torch.Tensor, X: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """Gather the rows of X per slot, multiply, sum along the width. bf16:
    operands and products rounded to bf16, the row sums taken in float32
    and rounded once."""
    xg = X[cols.long()]  # (R, W, k)
    if schedule.accum_dtype == "bfloat16":
        prods = bf16_round(bf16_round(data)[:, :, None] * bf16_round(xg))
        return bf16_round(prods.sum(dim=1))
    return torch.einsum("rw,rwk->rk", data, xg)


def spmm_launch_plan(R: int, W: int, k: int, n_sms: int) -> dict:
    """B8's launch from integers only: planes ``(R, W)``, ``k`` columns of
    X, the card's SM count.

    * ``vec``: columns a lane reads per load, 4 (one 16-byte load) where
      ``k % 4 == 0``, else 1.
    * ``lanes``: lanes per slot, the least power of two (at most 32) whose
      ``lanes * vec`` columns cover ``k``; the warp's ``32 / lanes`` slot
      groups multiply different slots, ``passes`` repeat it for wider k.
    * ``warps_per_row``: with one pass, the most of ``SPMM_SPLIT_CHOICES``
      (and no more than the row's chunks) until ``R * warps_per_row`` reaches
      ``SPMM_TARGET_WARPS_PER_SM`` warps per SM; warp q of a row takes the
      chunks ``[chunks * q / wpr, chunks * (q + 1) / wpr)``.
    * ``rows_per_warp``: enough that the grid is one wave of
      ``SPMM_RESIDENT_WARPS_PER_SM`` warps per SM, at least 1.
    """
    R, W, k, n_sms = int(R), int(W), int(k), int(n_sms)
    if k < 1 or R < 0 or W < 0 or n_sms < 1:
        raise ValueError(f"no SpMM launch for R={R}, W={W}, k={k}, n_sms={n_sms}")
    vec = 4 if k % 4 == 0 else 1
    lanes = next(g for g in SPMM_LANE_GROUPS if g * vec >= k or g == SPMM_LANE_GROUPS[-1])
    passes = -(-k // (lanes * vec))
    chunks = -(-W // SPMM_CHUNK)
    wpr = SPMM_SPLIT_CHOICES[0]
    if passes == 1:
        for nxt in SPMM_SPLIT_CHOICES[1:]:
            if R * wpr >= SPMM_TARGET_WARPS_PER_SM * n_sms or nxt > chunks:
                break
            wpr = nxt
    return spmm_grid(R, W, k, lanes, vec, wpr, _rows_per_warp(R, wpr, n_sms))


def _rows_per_warp(R: int, wpr: int, n_sms: int) -> int:
    """Rows a warp takes in turn so that the grid is one wave."""
    return max(1, -(-R * wpr // (SPMM_RESIDENT_WARPS_PER_SM * n_sms)))


def spmm_grid(R: int, W: int, k: int, lanes: int, vec: int, wpr: int, rpw: int) -> dict:
    """The plan's dict for given choices: what the C entry point takes, and
    the CTAs and warps that follow."""
    rows_per_cta = SPMM_WARPS_PER_CTA // wpr * rpw
    ctas = -(-R // rows_per_cta)
    return {"lanes": lanes, "vec": vec, "passes": -(-k // (lanes * vec)),
            "chunks": -(-W // SPMM_CHUNK), "warps_per_row": wpr, "rows_per_warp": rpw,
            "rows_per_cta": rows_per_cta, "ctas": ctas, "warps": ctas * SPMM_WARPS_PER_CTA}


def spmm_plan_choices(R: int, W: int, k: int, n_sms: int) -> list[dict]:
    """The plan and its alternatives: every valid warps-per-row with its
    rows-per-warp rule, and the plan's split at one row per warp."""
    plan = spmm_launch_plan(R, W, k, n_sms)
    out = [plan]
    for wpr in SPMM_SPLIT_CHOICES:
        if wpr > 1 and (plan["passes"] > 1 or wpr > max(plan["chunks"], 1)):
            continue
        for r in {_rows_per_warp(R, wpr, n_sms), 1}:
            alt = spmm_grid(R, W, k, plan["lanes"], plan["vec"], wpr, r)
            if alt not in out:
                out.append(alt)
    return out


def ell_live_width(data: torch.Tensor) -> torch.Tensor:
    """Live slots of each ELL row, ``(R,)`` int64: the index of its first
    zero value, else ``W``. Rows store their nonzeros first, so this is the
    row's length; B2 stops after the step and B8 after the chunk that holds
    it."""
    R, W = data.shape
    if not W:
        return torch.zeros(R, dtype=torch.int64, device=data.device)
    j = torch.arange(W, device=data.device).expand(R, W)
    return torch.where(data == 0, j, W).amin(dim=1)


def spmm_slots_read(live: torch.Tensor, W: int, plan: dict) -> int:
    """Plane slots B8 reads under ``plan`` for rows of ``live`` live slots:
    warp q of a row reads its chunks in order and stops after the one that
    holds the row's first padding slot (its first chunk at least), or at
    the end of its range."""
    chunks, wpr = plan["chunks"], plan["warps_per_row"]
    tail = torch.div(live, SPMM_CHUNK, rounding_mode="floor")  # chunk of the first padding slot
    total = torch.zeros_like(live)
    for q in range(wpr):
        beg, end = chunks * q // wpr, chunks * (q + 1) // wpr
        if beg == end:
            continue
        last = torch.clamp(tail, min=beg, max=end - 1)
        n = last - beg + 1
        # slots of the chunks read; the last chunk of the planes may be short
        total += torch.clamp(n * SPMM_CHUNK, max=W - beg * SPMM_CHUNK)
    return int(total.sum()) * plan["passes"]


def ell_spmm(
    data: torch.Tensor, cols: torch.Tensor, X: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """SpMM over padded ELL planes ``data/cols: (R, W)`` and a dense
    row-major ``X: (n_cols, k)``; returns ``Y: (R, k)`` (float32).

    The kernel's precondition (the module's note): each row's nonzeros come
    before its padding, so a row holds no stored zero before a nonzero.
    ``ell_from_dense`` writes planes so; the wrapper does not check planes
    from elsewhere, on which the kernel drops what follows a stored zero."""
    R, W = _check_planes(data, cols, X, "X", 2, schedule)
    if X.device.type == "cpu":
        return ell_spmm_plain(data, cols, X, schedule)
    if X.device.type != "cuda":
        raise RuntimeError(f"ell_spmm has no kernel for device {X.device}")
    plan = spmm_launch_plan(R, W, X.shape[1], sm_count(X.device))
    Y = _spmm_launch(data, cols, X, plan, schedule.accum_dtype == "bfloat16")
    ell_spmm.launches += 1
    return Y


def _spmm_launch(data, cols, X, plan: dict, accum_bf16: bool, reads=None) -> torch.Tensor:
    """Launch B8 under ``plan`` on X's CUDA device and current stream and
    return ``Y``. ``reads``: ``None``, or an int32 tensor of ``plan["warps"]``
    entries in which each warp writes the plane slots it loaded."""
    from repro_torch.kernels.build import bind, check_launch

    dev = X.device
    R, W = data.shape
    k = X.shape[1]
    if plan["vec"] == 4 and X.data_ptr() % 16:
        X = X.clone()  # a fresh allocation: 16-byte aligned rows for the float4 loads
    Y = torch.empty((R, k), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmm_ell", "spmm_ell_launch", [vp] * 4 + [ci] * 9 + [vp] * 2)
    with torch.cuda.device(dev):
        err = fn(data.data_ptr(), cols.data_ptr(), X.data_ptr(), Y.data_ptr(), R, W, k,
                 plan["lanes"], plan["vec"], plan["warps_per_row"], plan["rows_per_warp"],
                 plan["ctas"], int(accum_bf16), None if reads is None else reads.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "ell_spmm")
    return Y


ell_spmm.launches = 0  # kernel launches made by this process
