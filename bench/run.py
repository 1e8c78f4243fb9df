"""Run one cell of the port's benchmark on the CUDA card of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output; exits non-zero, printing no result, where the machine has
fewer CUDA devices than the cell asks for. Kernel libraries are built into
``build/`` inside the checkout, so only a checkout's first run compiles."""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("REPRO_TORCH_BUILD_DIR", "build/repro_torch"),
                 ("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton"),
                 ("CUDA_CACHE_PATH", "build/nv_compute_cache")):
    os.environ[var] = str(ROOT / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
