"""Structured tracing: nested spans with a thread-safe in-process collector.

Every hot-path section (``session.optimize`` → ``cache.lookup`` →
``kernel.compile`` → ``kernel.execute``) opens a *span*: a named, attributed
interval that records its parent from a per-thread stack, so one served
request becomes a small tree showing exactly where its wall time went —
plan-cache lookup vs. predictor inference vs. format prepare vs. execution.
The paper's headline numbers are *measured* latencies (§6.3); a trace stream
is how a serving reproduction keeps that measurement methodology inspectable
per request instead of trusting aggregate counters.

Cost discipline: an enabled span is one ``perf_counter`` pair plus a dict
append into a bounded deque; a disabled tracer hands out a shared no-op
context manager, so instrumented code pays one attribute read. Export is a
JSONL append-log following ``telemetry/recorder.py``'s torn-line convention
(a crash mid-append leaves at most one unparseable trailing line, which
``load_spans`` skips), and ``profile_capture`` optionally wraps a region in
``torch.profiler`` so the kernel launches can be opened in Perfetto.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from repro_torch.utils.logging import get_logger

log = get_logger("obs.trace")

TRACE_SCHEMA_VERSION = 1


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span; becomes a plain dict in the collector on exit."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id", "t0", "ts")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. hit/miss verdicts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self.span_id = tr._next_id()
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self.ts = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        dur = time.perf_counter() - self.t0
        stack = self.tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        rec = {
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "ts": self.ts,
            "dur_s": dur,
            "thread": threading.get_ident(),
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        self.tracer._collect(rec)
        return False


class Tracer:
    """Thread-safe span collector with bounded memory and JSONL export.

    ``max_spans`` bounds the in-process buffer (oldest spans drop first —
    a serving loop must not grow RSS with its request count); ``drops``
    counts what the bound discarded so exports are honest about truncation.
    """

    def __init__(self, *, enabled: bool = True, max_spans: int = 65536):
        self.enabled = enabled
        self.max_spans = int(max_spans)
        self._spans: deque[dict] = deque(maxlen=self.max_spans)
        self._exported = 0  # spans already flushed to the JSONL log
        self.drops = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._id_counter = 0

    # -------------------------------------------------------------- internals
    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._id_counter += 1
            return self._id_counter

    def _collect(self, rec: dict) -> None:
        with self._lock:
            if len(self._spans) == self.max_spans:
                self.drops += 1
                if self._exported:  # the dropped span was the oldest
                    self._exported -= 1
            self._spans.append(rec)

    # -------------------------------------------------------------------- api
    def span(self, name: str, **attrs):
        """Open a nested span; use as ``with tracer.span("cache.lookup"):``."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, attrs)

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._exported = 0
            self.drops = 0

    def summary(self) -> dict:
        """Per-name counts + total duration of the buffered spans."""
        by_name: dict[str, dict] = {}
        for rec in self.spans():
            cell = by_name.setdefault(rec["name"], {"count": 0, "total_s": 0.0})
            cell["count"] += 1
            cell["total_s"] += rec["dur_s"]
        return {"spans": sum(c["count"] for c in by_name.values()),
                "drops": self.drops, "by_name": by_name}

    # ------------------------------------------------------------ persistence
    def export_jsonl(self, path: str | Path) -> int:
        """Append spans not yet exported to a JSONL shard; returns lines.

        Same crash tolerance as the telemetry recorder: if the file's last
        byte is not a newline (a torn previous append), a newline is
        prepended so only that one already-torn line is lost on replay."""
        path = Path(path)
        with self._lock:
            fresh = list(self._spans)[self._exported:]
            self._exported = len(self._spans)
        if not fresh:
            return 0
        path.parent.mkdir(parents=True, exist_ok=True)
        chunk = "".join(json.dumps(r, sort_keys=True) + "\n" for r in fresh)
        if path.exists() and path.stat().st_size:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    chunk = "\n" + chunk
        with open(path, "a") as f:
            f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        return len(fresh)


def load_spans(path: str | Path) -> list[dict]:
    """Replay a span JSONL shard, skipping torn/foreign lines."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn trailing line from an interrupted append
        if isinstance(rec, dict) and "name" in rec and "dur_s" in rec:
            out.append(rec)
    return out


def span_children(spans: list[dict], parent_id) -> list[dict]:
    """The direct children of one span (trace-tree navigation helper)."""
    return [s for s in spans if s.get("parent") == parent_id]


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every instrumented module shares."""
    return _TRACER


def span(name: str, **attrs):
    """Module-level convenience: ``with span("session.optimize"): ...``."""
    return _TRACER.span(name, **attrs)


class profile_capture:
    """Optionally wrap a region in ``torch.profiler`` (Perfetto-viewable).

    ``with profile_capture("artifacts/profile"):`` records every CPU op and
    CUDA kernel launched inside and writes ``trace.json`` (Chrome trace
    format) into the directory on exit. Failures (no profiler support in
    this torch build, a capture already running) degrade to a logged
    warning — profiling is diagnostic, never load-bearing."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = str(log_dir)
        self._prof = None

    def __enter__(self):
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            log.info("torch profiler capture -> %s", self.log_dir)
        except Exception as exc:
            self._prof = None
            log.warning("profiler capture unavailable (%s); continuing", exc)
        return self

    def __exit__(self, *exc) -> bool:
        if self._prof is not None:
            try:
                self._prof.__exit__(None, None, None)
                Path(self.log_dir).mkdir(parents=True, exist_ok=True)
                self._prof.export_chrome_trace(str(Path(self.log_dir) / "trace.json"))
            except Exception as stop_exc:
                log.warning("profiler stop failed (%s)", stop_exc)
        return False
