"""Structured logging for the repro_torch package.

One logger per subsystem; format includes wall-clock so multi-hour runs
(dataset collection, dry-run sweeps) are auditable after the fact.

Two knobs, settable programmatically (``configure``) or via environment:

* level — ``REPRO_LOG_LEVEL`` (default INFO);
* JSON-line mode — ``REPRO_LOG_JSON=1`` emits one JSON object per record
  (``ts``/``level``/``logger``/``msg`` + exception text when present), the
  shape log shippers and the obs aggregation tooling ingest without regex.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False
_handler: logging.Handler | None = None


class JsonLineFormatter(logging.Formatter):
    """One JSON object per record — machine-parseable structured logs."""

    def format(self, record: logging.LogRecord) -> str:
        rec = {
            "ts": round(record.created, 6),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(record.created)
            ),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            rec["exc"] = self.formatException(record.exc_info)
        return json.dumps(rec, default=str)


def _configure_root() -> None:
    global _configured, _handler
    if _configured:
        return
    _handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("REPRO_LOG_JSON", "").strip() in ("1", "true", "yes"):
        _handler.setFormatter(JsonLineFormatter())
    else:
        _handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger("repro_torch")
    root.addHandler(_handler)
    root.setLevel(os.environ.get("REPRO_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _configured = True


def configure(
    level: str | int | None = None, *, json_lines: bool | None = None
) -> None:
    """Reconfigure the repro_torch root logger after the fact.

    ``level`` accepts a name ("DEBUG") or a numeric level; ``json_lines``
    switches the single stderr handler between the human format and
    one-JSON-object-per-line. Either argument may be omitted to leave that
    aspect unchanged."""
    _configure_root()
    root = logging.getLogger("repro_torch")
    if level is not None:
        root.setLevel(level.upper() if isinstance(level, str) else level)
    if json_lines is not None and _handler is not None:
        _handler.setFormatter(
            JsonLineFormatter()
            if json_lines
            else logging.Formatter(_FORMAT, datefmt="%H:%M:%S")
        )


def get_logger(name: str) -> logging.Logger:
    """Return a logger namespaced under ``repro_torch``."""
    _configure_root()
    if not name.startswith("repro_torch"):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)
