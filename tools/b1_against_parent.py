#!/usr/bin/env python3
"""B1 (``src/repro_torch/csrc/spmv_csr.cu``) against another build of it on
the card, given the ``csrc`` directory of that other tree (its
``spmv_csr.cu`` and ``common.cuh``; the C entry point must be the same):

    python3 tools/b1_against_parent.py PARENT_CSRC_DIR

On ``human_gene2`` (published size) and ``webgraph@14011`` (hub rows), at
``chip_smoke.py``'s six schedules and at rows 8 / unroll 8 in both
accumulators, both builds run through ``_csr_launch`` on the same plan,
scratch and x:

* float32 schedules: whether the two ``y`` are the same bits;
* bfloat16 schedules: the error of each against the float64 host product
  (scaled by max |y|), over all rows and, over 16 x vectors, on webgraph's
  hub row (mean and max);
* times in turns (parent, this, this, parent; ``ROUNDS`` rounds of
  ``chip_smoke.timed``: CUDA events, L2 flushed), medians and every run.

Prints one JSON object and writes it to ``build/b1_against_parent.json``.
Needs one CUDA device and ``nvcc``.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 6
DRAWS = 16


def main(parent_csrc: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # exits 2 where there is no card
    import numpy as np
    import torch

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.csr import _csr_launch, csr_launch_plan

    kbuild.build_all(("spmv_csr",))
    out_so = kbuild.build_dir() / "parent" / "spmv_csr_parent.so"
    out_so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-I", parent_csrc, "-o",
                    str(out_so), os.path.join(parent_csrc, "spmv_csr.cu")], check=True,
                   capture_output=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    kbuild.bind("spmv_csr", "spmv_csr_launch", [vp] * 5 + [ci] * 8 + [vp] * 3 + [ci, ci, vp])
    key = ("spmv_csr", "spmv_csr_launch")
    this_fn = kbuild._FUNCS[key]
    parent_fn = ctypes.CDLL(str(out_so)).spmv_csr_launch
    parent_fn.argtypes, parent_fn.restype = this_fn.argtypes, ctypes.c_int

    def launch(which: str, mat, x, sched):
        plan = csr_launch_plan(mat.shape[0], mat.data.shape[0], sched.rows_per_block,
                               sched.unroll, cs.sm_count(cs.DEVICE), n_cols=x.shape[0])
        kbuild._FUNCS[key] = parent_fn if which == "parent" else this_fn
        try:
            return _csr_launch(mat.data, mat.indices, mat.indptr, x, plan, sched)
        finally:
            kbuild._FUNCS[key] = this_fn

    scheds = list(cs.SCHEDULES) + [
        cs.KernelSchedule(rows_per_block=8, nnz_tile=1024, unroll=8, accum_dtype=acc)
        for acc in ("float32", "bfloat16")]
    web = cs.generate_by_name("webgraph", scale=cs.WEB_SCALE)
    mats = {"human_gene2": cs.generate_by_name("human_gene2", scale=1.0,
                                               max_elems=cs.SUITE["human_gene2"].n ** 2),
            f"webgraph@{web.shape[0]}": web}
    rng = np.random.default_rng(cs.SEED + 28)
    result = {"card": cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"]), "rounds": ROUNDS, "cases": []}
    for name, dense in mats.items():
        x_host = rng.normal(size=dense.shape[1]).astype(np.float32)
        ref = cs.host_product(dense, x_host)
        x = torch.as_tensor(x_host, device=cs.DEVICE)
        for sched in scheds:
            mat = cs.prepare(dense, "csr", sched, device=cs.DEVICE)
            bf16 = sched.accum_dtype == "bfloat16"
            y = {w: launch(w, mat, x, sched) for w in ("parent", "this")}
            row = {"matrix": name, "schedule": cs.sched_tag(sched)}
            if bf16:
                row.update({f"{w}_err": cs.scaled_err(y[w].cpu().numpy(), ref) for w in y})
            else:
                row["same_bits"] = bool(torch.equal(y["parent"].view(torch.int32),
                                                    y["this"].view(torch.int32)))
            runs = {"parent": [], "this": []}
            for _ in range(ROUNDS):
                for w in ("parent", "this", "this", "parent"):
                    runs[w].append(cs.timed(lambda: launch(w, mat, x, sched)))
            row.update({f"{w}_ms": float(np.median(v)) for w, v in runs.items()})
            row["ratio"] = row["this_ms"] / row["parent_ms"]
            row["runs_ms"] = runs
            result["cases"].append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "runs_ms"}), flush=True)
    # webgraph's hub row in bf16 over DRAWS x vectors, as chip_smoke's b1_hub_bf16
    hub = int(np.argmax((web != 0).sum(axis=1)))
    xs = [rng.normal(size=web.shape[1]).astype(np.float32) for _ in range(DRAWS)]
    refs = [cs.host_product(web, x) for x in xs]
    result["hub_row"] = {"row": hub, "row_nnz": int((web[hub] != 0).sum()), "draws": DRAWS}
    for sched in [s for s in scheds if s.accum_dtype == "bfloat16"]:
        mat = cs.prepare(web, "csr", sched, device=cs.DEVICE)
        errs = {"parent": [], "this": [], "parent_all_rows": [], "this_all_rows": []}
        for x_host, ref in zip(xs, refs):
            x = torch.as_tensor(x_host, device=cs.DEVICE)
            scale = float(np.abs(ref).max())
            for w in ("parent", "this"):
                y = launch(w, mat, x, sched).cpu().numpy()
                errs[w].append(abs(float(y[hub]) - ref[hub]) / scale)
                errs[w + "_all_rows"].append(cs.scaled_err(y, ref))
        result["hub_row"][cs.sched_tag(sched)] = {
            k: {"mean": float(np.mean(v)), "max": float(np.max(v))} for k, v in errs.items()}
    print(json.dumps(result["hub_row"]), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "b1_against_parent.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(os.path.abspath(sys.argv[1]))
