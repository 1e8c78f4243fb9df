#!/usr/bin/env python3
"""Host profile of ``chip_smoke.py``: runs its ``main()`` under ``cProfile``
with one profile per phase line (from the previous line to this one) and
writes each phase's top 30 functions by cumulative time to
``build/profile/NN_<phase>.txt`` (the ``.prof`` beside it for
``pstats``). Everything the script prints is printed as usual; the profiler
slows host-bound parts, so the seconds on its phase lines are not the
script's own.

    python3 tools/chip_profile.py

Needs what ``chip_smoke.py`` needs (one CUDA device, ``nvcc``); exits as it
does without one.
"""
import cProfile
import io
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "profile")
TOP = 30


def main() -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke  # exits 2 where there is no card

    os.makedirs(OUT, exist_ok=True)
    shown = chip_smoke.emit
    state = {"prof": cProfile.Profile(), "n": 0}

    def emit(phase: str, **payload) -> None:
        prof = state["prof"]
        prof.disable()
        shown(phase, **payload)
        stem = os.path.join(OUT, f"{state['n']:02d}_{phase}")
        prof.dump_stats(stem + ".prof")
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(TOP)
        with open(stem + ".txt", "w") as f:
            f.write(text.getvalue())
        state["n"] += 1
        state["prof"] = cProfile.Profile()
        state["prof"].enable()

    chip_smoke.emit = emit
    state["prof"].enable()
    try:
        chip_smoke.main()
    finally:
        state["prof"].disable()


if __name__ == "__main__":
    main()
