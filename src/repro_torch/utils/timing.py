"""Wall-time measurement helpers + streaming sample statistics.

The paper measures kernel latency by repeated runs and averaging (Section
6.3, 500-200000 reps per kernel). ``measure_wall_time`` reproduces that
protocol for host-clock measurement: warmup, then ``reps`` timed calls, each followed by
``torch.cuda.synchronize()`` when the result lives on a CUDA device so the
asynchronous launch queue does not hide work. ``cuda_time_ms`` times a
callable on the device's own clock with CUDA events.

``ewma`` / ``percentile`` / ``RollingStats`` are the aggregation primitives
the telemetry recorder builds per-arm latency estimates from: all-time
count/mean (Welford), an exponentially-weighted moving average that tracks
drift, and percentiles over a bounded recent window.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch


def ewma(prev: float | None, sample: float, alpha: float = 0.2) -> float:
    """One EWMA step; the first sample initializes the average.

    ``alpha`` is the weight of the new sample (0 < alpha <= 1): higher
    tracks drift faster, lower smooths measurement noise harder.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    if prev is None:
        return float(sample)
    return alpha * float(sample) + (1.0 - alpha) * prev


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of ``samples`` (q in [0, 100]).

    Returns NaN for an empty window and the sample itself for a single
    observation — callers treat NaN as "no signal yet", not as zero.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    xs = sorted(float(s) for s in samples)
    if not xs:
        return math.nan
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class RollingStats:
    """Streaming sample aggregator: all-time mean + EWMA + windowed percentiles.

    ``count``/``mean`` cover every sample ever added (Welford update, no
    storage); ``ewma`` weights recent samples; ``percentile(q)`` and ``min``/
    ``max`` are computed over the last ``window`` samples only, bounding
    memory per telemetry arm.
    """

    def __init__(self, window: int = 128, ewma_alpha: float = 0.2):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self.ewma_alpha = float(ewma_alpha)
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0  # Welford sum of squared deviations
        self.ewma: float | None = None
        self.last: float | None = None
        self._recent: deque[float] = deque(maxlen=self.window)

    def add(self, sample: float) -> None:
        x = float(sample)
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        self.ewma = ewma(self.ewma, x, self.ewma_alpha)
        self.last = x
        self._recent.append(x)

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.count - 1))

    def percentile(self, q: float) -> float:
        return percentile(self._recent, q)

    def window_mean(self) -> float:
        """Mean over the last ``window`` samples only (NaN when empty) — the
        short-horizon signal burn-rate windows need, where the all-time
        ``mean`` would dilute a fresh overload with ancient history."""
        if not self._recent:
            return math.nan
        return sum(self._recent) / len(self._recent)

    def window_min(self) -> float:
        return min(self._recent) if self._recent else math.nan

    def window_max(self) -> float:
        return max(self._recent) if self._recent else math.nan

    def as_dict(self) -> dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "std": self.std,
            "ewma": math.nan if self.ewma is None else self.ewma,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
        }


@dataclass
class Timer:
    """Accumulating context-manager timer, reusable across sections."""

    elapsed: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed += time.perf_counter() - self._t0


def _leaves(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)
    elif hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            yield from _leaves(getattr(out, name))


def _block(out: Any) -> None:
    """Wait for every CUDA tensor reachable from ``out`` (CPU tensors are
    already complete when the call returns)."""
    devices = {leaf.device for leaf in _leaves(out) if leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def measure_wall_time(
    fn: Callable[[], Any],
    *,
    warmup: int = 2,
    reps: int = 5,
    min_time_s: float = 0.0,
) -> dict[str, float]:
    """Time ``fn`` with warmup; returns mean/min/std seconds over reps.

    ``min_time_s`` keeps measuring past ``reps`` until the accumulated timed
    window reaches the floor — the paper's variable 500-200000 rep protocol,
    bounded for practicality.
    """
    for _ in range(warmup):
        _block(fn())
    samples: list[float] = []
    total = 0.0
    while len(samples) < reps or total < min_time_s:
        t0 = time.perf_counter()
        _block(fn())
        dt = time.perf_counter() - t0
        samples.append(dt)
        total += dt
        if len(samples) >= 10000:  # hard cap
            break
    n = len(samples)
    mean = sum(samples) / n
    var = sum((s - mean) ** 2 for s in samples) / max(n - 1, 1)
    return {
        "mean_s": mean,
        "min_s": min(samples),
        "std_s": var**0.5,
        "reps": float(n),
    }


# several times any current L2, and long enough to write (~0.3 ms at 3.35
# TB/s) that the host enqueues ``fn`` while the device is still busy
_L2_FLUSH_BYTES = 1024 * 1024 * 1024
_flush_buffers: dict = {}


def cuda_time_ms(
    fn: Callable[[], Any], *, warmup: int = 3, reps: int = 20
) -> dict[str, float]:
    """Time ``fn`` on the current CUDA device with events; milliseconds.

    Each repetition is bracketed by its own event pair on the current
    stream, so the figure is device time, not host enqueue time. A buffer
    larger than the L2 cache is overwritten before every repetition, outside
    the timed pair: ``fn`` finds the cache cold, as a served request does,
    and the flush keeps the device busy while the host enqueues ``fn``.
    A repetition whose host enqueue of ``fn`` took longer than the flush ran
    on the device is "late": its pair may hold the idle gap before ``fn``'s
    first launch, so the statistics leave it out, unless every repetition is
    late (then they keep all, and ``late`` says so). Returns median/mean/min
    and the quartiles (``q1_ms``, ``q3_ms``) over the repetitions kept,
    their count, the late count, and the flush's and the host enqueue's
    median milliseconds. Raises when no CUDA device is present — a device
    time is never taken on the host.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    dev = torch.cuda.current_device()
    flush = _flush_buffers.get(dev)
    if flush is None:
        flush = _flush_buffers[dev] = torch.empty(
            _L2_FLUSH_BYTES, dtype=torch.uint8, device=f"cuda:{dev}"
        )
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        before = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before.record()
        flush.zero_()
        start.record()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        runs.append((before, start, end, host_ms))
    torch.cuda.synchronize()
    flush_ms = [b.elapsed_time(s) for b, s, _, _ in runs]
    device_ms = [s.elapsed_time(e) for _, s, e, _ in runs]
    late = [h > f for (_, _, _, h), f in zip(runs, flush_ms)]
    kept = sorted(d for d, x in zip(device_ms, late) if not x) or sorted(device_ms)
    return {
        "median_ms": _median(kept),
        "mean_ms": sum(kept) / len(kept),
        "min_ms": kept[0],
        "q1_ms": percentile(kept, 25),
        "q3_ms": percentile(kept, 75),
        "reps": float(len(kept)),
        "late": float(sum(late)),
        "flush_ms": _median(sorted(flush_ms)),
        "host_ms": _median(sorted(h for _, _, _, h in runs)),
    }


def _median(xs: list[float]) -> float:
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
