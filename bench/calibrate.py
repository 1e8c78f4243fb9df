"""Readings that a cell's limits are set from, in one process on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 1 --base <n> --out <file.json>

runs the cell's own set-up, a short window at its own load and its check on
``--seeds`` seeds (``base``, ``base + 1``, ...), then the control (the same
path with bfloat16 accumulation) on the first ``--control-seeds`` of them,
and writes each seed's compared numbers. The tuner is built once and shared,
since it does not depend on the seed. The benchmark's own runs never run the
control. A limit goes above every reading of the program, with room, and
below every reading of the control."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench.harness.catalog import Catalog  # noqa: E402
from bench.harness.main import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--base", type=int, default=2**33 + 101)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    catalog, device, tuner, rows = Catalog.load(), torch.device("cuda", 0), None, []
    plan = [(args.base + k, False) for k in range(args.seeds)]
    plan += [(args.base + k, True) for k in range(args.control_seeds)]
    for seed, control in plan:
        t = time.perf_counter()
        result, check, system = run_cell(catalog, args.workload, seed, args.seconds, False,
                                         device, t, control=control, tuner=tuner)
        tuner = system.tuner
        row = {"seed": seed, "control": control, "correct": result["correct"],
               "check": check, "metrics": result["metrics"], "served": result["served"],
               "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    program = [r["check"]["max_rel_err"]["value"] for r in rows if not r["control"]]
    control = [r["check"]["max_rel_err"]["value"] for r in rows if r["control"]]
    print(json.dumps({"workload": args.workload, "program_max": max(program),
                      "control_min": min(control) if control else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
