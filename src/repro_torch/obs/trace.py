"""Structured tracing: nested spans on the profiler's clock, with device times.

Every section worth splitting opens a *span*: a named, attributed interval
that records its parent and its root (``trace``) from a per-thread stack, so
one served request becomes a small tree showing where its wall time went.
Planning (``session.optimize`` → ``cache.lookup`` → ``kernel.compile``),
set-up (``tuner.build``, ``session.analyze``, ``engine.register``) and the
served path (``engine.matmul`` → ``spmv.call`` → ``kernel.launch``) are
instrumented. The paper's headline numbers are *measured* latencies (§6.3);
a trace stream keeps that measurement inspectable per request.

The process-wide tracer starts **off**. ``get_tracer().enabled = True`` (or
``obs.set_obs_enabled(True)``, or a CLI's ``--trace-export``) switches it on;
while it is off, a served-path site reads ``enabled`` once and builds no span,
no attribute dict and no CUDA event.

Clock: ``start_ns`` / ``end_ns`` are ``time.perf_counter_ns()`` readings
shifted, by one offset taken when the tracer is switched on, onto the
Unix-epoch nanoseconds that ``torch.profiler`` stamps its events with, so
exported spans overlay a profiler trace. ``dur_s`` is their difference.

Device times: a span opened with ``device_span`` on a CUDA device records a
CUDA event on the device's current stream as it opens and another as it
closes, from a pool of event pairs made when the tracer meets the device
(at switch-on for the current device), never per call, and with no
synchronise on the call's path. ``spans()`` turns the events that have
completed into ``dev_start_ns`` / ``dev_end_ns`` on the same clock: an
anchor event recorded after a synchronise at switch-on, and a closing one
each time completed events are read, put them on the host clock between the
two (``_DeviceClock``; ``cudaEventElapsedTime`` is a float32 of ms, about
0.6 us of resolution ten seconds after an anchor). A span that finds the
pool empty carries no device times and counts in ``device_drops``.

Cost discipline: an enabled span is two clock readings, a per-thread stack
push and a dict append into a bounded deque (``drops`` counts what the bound
discarded); a device span adds two event records. Export is a JSONL
append-log following ``telemetry/recorder.py``'s torn-line convention (a
crash mid-append leaves at most one unparseable trailing line, which
``load_spans`` skips), and ``profile_capture`` optionally wraps a region in
``torch.profiler`` so the kernel launches can be opened in Perfetto.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.utils.logging import get_logger

log = get_logger("obs.trace")

_ANCHOR_PROBES = 8  # anchor recordings; the tightest host bracket wins
perf_counter_ns = time.perf_counter_ns
get_ident = threading.get_ident


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


def _epoch_offset_ns() -> int:
    """Unix-epoch ns minus ``perf_counter_ns``, from the tightest of a few
    paired readings."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _DeviceClock:
    """One CUDA device's event pairs, the anchors that put its events on the
    host clock, and the spans whose events are still to be read.

    An anchor is an event recorded on a side stream of the clock's own (idle,
    so the card records it at once) and timed against the host: each of a few
    probes lies between the host's readings around its record and its
    synchronise, and the tightest bound over them wins. The card's event
    clock drifts from the host's by a few parts per million (about 2.5 us a
    second on the H100), so reading completed events takes a closing anchor
    after them and places them linearly between it and the one before."""

    def __init__(self, index: int, pairs: int, now):
        self.index = index
        self.now = now
        self._lock = threading.Lock()
        self.pending: deque = deque()  # (record, start event, end event)
        # torch.cuda.Event's C base: its objects are not tracked by the
        # garbage collector (a Python subclass's are, and a pool of tens of
        # thousands would slow every full collection of the process), and
        # its record is one Python frame shorter
        self.event = event = torch._C._CudaEventBase
        self.record = event.record
        self._raw_stream = torch._C._cuda_getCurrentRawStream
        self._raw, self._stream = None, None
        stream = torch.cuda.current_stream(index)
        self.pool = []
        for _ in range(pairs):
            pair = (event(enable_timing=True), event(enable_timing=True))
            for ev in pair:
                self.record(ev, stream)  # creates the CUDA event now, on this device
            self.pool.append(pair)
        self._side = torch.cuda.Stream(index)
        self._probes = [event(enable_timing=True) for _ in range(_ANCHOR_PROBES)]
        self.last = None  # (event, host ns): the newest anchor
        self.restart()

    def restart(self) -> None:
        """At switch-on: read what is pending, then an anchor after a
        synchronise of the device."""
        torch.cuda.synchronize(self.index)
        self.resolve()
        self.last = self._anchor()

    def _anchor(self) -> tuple:
        ref = self.event(enable_timing=True)  # the anchor's own event, kept with it
        lo = hi = None
        for ev in (ref, *self._probes):
            t0 = self.now()
            self.record(ev, self._side)
            ev.synchronize()
            t1 = self.now()
            rel = 0 if ev is ref else round(ref.elapsed_time(ev) * 1e6)
            lo = t0 - rel if lo is None else max(lo, t0 - rel)
            hi = t1 - rel if hi is None else min(hi, t1 - rel)
        return ref, ((lo + hi) // 2 if lo <= hi else lo)

    def current_stream(self):
        """The device's current stream; the ``torch.cuda.Stream`` is made
        again only when the raw handle changes."""
        raw = self._raw_stream(self.index)
        if raw != self._raw:
            self._raw, self._stream = raw, torch.cuda.current_stream(self.index)
        return self._stream

    def take(self):
        """An event pair, or ``None`` when every pair is in flight."""
        try:
            return self.pool.pop()
        except IndexError:
            self.resolve()
        try:
            return self.pool.pop()
        except IndexError:
            return None

    def resolve(self) -> None:
        """Device times of the pending spans whose events completed, in the
        order they were recorded, between the newest anchor and a closing
        one taken now; their pairs go back to the pool."""
        with self._lock:
            done = []
            while self.pending and self.pending[0][2].query():
                done.append(self.pending.popleft())
            if not done:
                return
            (e0, h0), closing = self.last, self._anchor()
            ns_per_ms = (closing[1] - h0) / e0.elapsed_time(closing[0])
            for rec, a, b in done:
                rec["dev_start_ns"] = h0 + round(e0.elapsed_time(a) * ns_per_ms)
                rec["dev_end_ns"] = h0 + round(e0.elapsed_time(b) * ns_per_ms)
                self.pool.append((a, b))
            self.last = closing


class _Span:
    """One live span; becomes a plain dict in the collector on exit."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id", "trace_id", "start_ns",
                 "device", "clock", "events", "stream", "stack", "thread")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict, device=None):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.device = device

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. hit/miss verdicts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self.thread = tid = get_ident()
        stack = tr._stacks.get(tid)
        if stack is None:
            stack = tr._stacks[tid] = []
        self.stack = stack
        self.span_id = sid = next(tr._ids)
        self.parent_id = stack[-1] if stack else None
        self.trace_id = stack[0] if stack else sid
        stack.append(sid)
        self.events = None
        if self.device is not None:
            self.clock = clock = tr._clock(self.device)
            self.events = clock.take()
            if self.events is None:
                tr._device_drop()
            else:
                self.stream = clock.current_stream()
                clock.record(self.events[0], self.stream)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        end_ns = perf_counter_ns()
        if self.events is not None:
            self.clock.record(self.events[1], self.stream)
        stack = self.stack
        if stack and stack[-1] == self.span_id:
            stack.pop()
        tr = self.tracer
        off = tr._offset_ns
        rec = {
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "trace": self.trace_id,
            "start_ns": self.start_ns + off,
            "end_ns": end_ns + off,
            "dur_s": (end_ns - self.start_ns) / 1e9,
            "thread": self.thread,
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.events is not None:
            self.clock.pending.append((rec, *self.events))
        spans = tr._spans
        if len(spans) == tr.max_spans:
            tr._drop_oldest()
        spans.append(rec)  # deque.append is atomic
        return False


class Tracer:
    """Thread-safe span collector with bounded memory and JSONL export.

    ``max_spans`` bounds the in-process buffer (oldest spans drop first —
    a serving loop must not grow RSS with its request count); ``drops``
    counts what the bound discarded and ``device_drops`` the device spans
    that found no free event pair, so exports are honest about truncation.
    A CUDA device gets ``max_spans // 2`` event pairs: a served call's span
    and its launch span fill the buffer as its pairs run out.
    """

    def __init__(self, *, enabled: bool = False, max_spans: int = 65536):
        self.max_spans = int(max_spans)
        self._spans: deque[dict] = deque(maxlen=self.max_spans)
        self._exported = 0  # spans already flushed to the JSONL log
        self.drops = 0
        self.device_drops = 0
        self._lock = threading.Lock()
        self._stacks: dict[int, list[int]] = {}  # open span ids, by thread
        self._ids = itertools.count(1)  # next() on it is atomic in CPython
        self._clocks: dict[int, _DeviceClock] = {}
        self._offset_ns = 0
        self._on = False
        self.enabled = enabled

    @property
    def enabled(self) -> bool:
        return self._on

    @enabled.setter
    def enabled(self, on: bool) -> None:
        """Switching on takes the clock's offset and anchors each device's
        events (the current CUDA device's pool is made here if CUDA is up)."""
        on = bool(on)
        if on and not self._on:
            self._offset_ns = _epoch_offset_ns()
            for clock in self._clocks.values():
                clock.restart()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                self._clock(torch.device("cuda", torch.cuda.current_device()))
        self._on = on

    # -------------------------------------------------------------- internals
    def now_ns(self) -> int:
        """``perf_counter_ns`` on the Unix-epoch clock of ``torch.profiler``."""
        return perf_counter_ns() + self._offset_ns

    def _drop_oldest(self) -> None:
        """The buffer is full: the next append pushes out its oldest span."""
        with self._lock:
            self.drops += 1
            if self._exported:
                self._exported -= 1

    def _device_drop(self) -> None:
        with self._lock:
            self.device_drops += 1

    def _clock(self, device: torch.device) -> _DeviceClock:
        index = device.index if device.index is not None else torch.cuda.current_device()
        clock = self._clocks.get(index)
        if clock is None:
            with self._lock:
                clock = self._clocks.get(index)
                if clock is None:
                    clock = self._clocks[index] = _DeviceClock(index, self.max_spans // 2,
                                                               self.now_ns)
        return clock

    # -------------------------------------------------------------------- api
    def span(self, name: str, **attrs):
        """Open a nested span; use as ``with tracer.span("cache.lookup"):``."""
        if not self._on:
            return NOOP_SPAN
        return _Span(self, name, attrs)

    def device_span(self, name: str, device: torch.device, **attrs):
        """``span``, timed on ``device`` too where it is a CUDA device: an
        event before the span's first device operation, one after its last."""
        if not self._on:
            return NOOP_SPAN
        return _Span(self, name, attrs, device if device.type == "cuda" else None)

    def _resolve(self) -> None:
        for clock in list(self._clocks.values()):
            clock.resolve()

    def spans(self) -> list[dict]:
        """The buffered spans, device times read where their events completed."""
        self._resolve()
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._exported = 0
            self.drops = 0
            self.device_drops = 0

    # ------------------------------------------------------------ persistence
    def export_jsonl(self, path: str | Path) -> int:
        """Append spans not yet exported to a JSONL shard; returns lines.

        Same crash tolerance as the telemetry recorder: if the file's last
        byte is not a newline (a torn previous append), a newline is
        prepended so only that one already-torn line is lost on replay."""
        path = Path(path)
        self._resolve()
        with self._lock:
            snapshot = list(self._spans)
            fresh = snapshot[self._exported:]
            self._exported = len(snapshot)
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


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every instrumented module shares (off until
    switched on)."""
    return _TRACER


def span(name: str, **attrs):
    """Module-level convenience: ``with span("session.optimize"): ...``."""
    return _TRACER.span(name, **attrs)


@contextmanager
def tracing(on: bool = True):
    """The process-wide tracer, switched on for the block where ``on`` (the
    run whose spans a caller exports), then left as it was."""
    before = _TRACER.enabled
    if on:
        _TRACER.enabled = True
    try:
        yield _TRACER
    finally:
        _TRACER.enabled = before


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
