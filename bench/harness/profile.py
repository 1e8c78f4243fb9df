"""Device time from ``torch.profiler``: busy time, kernels by name, and the
idle gaps by what the host was doing.

A cell's stretch of calls runs twice after the measured window. The first
run traces the device's activity alone, unannotated, so that the host makes
its calls at their own pace: busy time, kernel time and the stretch's length
(host clock, first call to the last wait) come from it; it is long enough
(about a second) that the tracer's own buffer requests are a small part of
it. The second, shorter run traces the host's operations too, inside a
``record_function`` named ``STRETCH``; that slows the host, so only the
labels of the idle gaps are taken from it, with their seconds in that slower
stretch.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

STRETCH = "bench.stretch"


@dataclass
class Profile:
    window_s: float  # the stretch, host clock
    busy_s: float  # union of device activity inside it
    kernel_s: float  # device time of kernels (no copies or sets)
    steps: int
    device_ops: list = field(default_factory=list)  # [[name, seconds]], top 10
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]], top 10


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every event of the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if on_device and (e.name().startswith("bench.")
                          or getattr(e, "is_user_annotation", lambda: False)()):
            continue  # the device's copy of a host range, not device work
        out.append((e.name(), on_device, start, end))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top(d: dict) -> list:
    return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _activities(device, host: bool):
    acts = [torch.profiler.ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def profile_stretch(stretch, device, steps: int, label_steps: int) -> Profile:
    """Trace ``stretch(n, annotate)`` (``n`` calls, ending with a wait for
    the device; ``annotate``: name the host's parts with ``record_function``)
    as the module's docstring says: ``steps`` calls, then ``label_steps``."""
    with torch.profiler.profile(activities=_activities(device, host=False)) as prof:
        t0 = time.perf_counter()
        stretch(steps, False)
        window_s = time.perf_counter() - t0
    device_ev = [(n, s, e) for n, dev, s, e in _events(prof) if dev]
    busy = _union([(s, e) for _, s, e in device_ev])
    by_name, kernel_ns = defaultdict(int), 0
    for n, s, e in device_ev:
        by_name[n] += e - s
        if not n.startswith(("Memcpy", "Memset")):
            kernel_ns += e - s
    with torch.profiler.profile(activities=_activities(device, host=True)) as prof:
        with torch.profiler.record_function(STRETCH):
            stretch(label_steps, True)
    return Profile(window_s=window_s, busy_s=sum(e - s for s, e in busy) / 1e9,
                   kernel_s=kernel_ns / 1e9, steps=steps, device_ops=_top(by_name),
                   idle_gaps=idle_gaps(_events(prof)))


def idle_gaps(events) -> list:
    """Seconds in which the device idled inside the ``STRETCH`` range, by the
    innermost host operation running at each gap's middle."""
    host = [(n, s, e) for n, dev, s, e in events if not dev]
    span = [(s, e) for n, s, e in host if n == STRETCH]
    if not span:
        raise RuntimeError(f"no {STRETCH!r} range in the profile")
    w0, w1 = span[0]
    busy = _union([(max(s, w0), min(e, w1)) for _, dev, s, e in events
                   if dev and e > w0 and s < w1])
    inner = [(n, s, e) for n, s, e in host if n != STRETCH and s < w1 and e > w0]
    gaps = defaultdict(int)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        over = [(e - s, n) for n, s, e in inner if s <= mid < e]
        gaps[min(over)[1] if over else "host, outside any traced call"] += g1 - g0
    return _top(gaps)
