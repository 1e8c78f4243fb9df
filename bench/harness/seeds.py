"""Seeds of the parts of a run, derived from the run's ``--seed``.

``--seed`` may be any whole number, larger than 32 bits hold and negative
too; each part (the matrix, the pool, the sample of answers) gets a 63-bit
seed of its own from the pair ``(seed, part)``."""

from __future__ import annotations

import hashlib


def subseed(seed: int, part: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{part}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
