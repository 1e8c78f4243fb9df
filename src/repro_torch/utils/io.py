"""Crash-safe file writing.

A serving fleet persists its tuning cache and telemetry state while live
traffic is in flight; a plain ``write_text`` interrupted mid-write (OOM
kill, preemption, power loss) leaves a truncated JSON file that forces the
next process into a cold start — exactly the degradation the cache exists
to avoid. ``atomic_write_text`` writes to a temporary file in the *same
directory* (same filesystem, so the rename is atomic) and ``os.replace``s
it into place: readers see either the old complete file or the new one,
never a torn write.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path


def atomic_write_text(path: str | Path, text: str) -> Path:
    """Write ``text`` to ``path`` atomically (temp file + ``os.replace``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=f".{path.name}.", suffix=".tmp", dir=path.parent
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
