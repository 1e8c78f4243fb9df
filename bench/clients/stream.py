"""One closed-loop client that keeps a resident plan busy: calls on pooled
device inputs are dispatched ahead, and the client waits for the device once
every ``sync_every`` calls (a solver or analytics caller, or a decode loop).

Mix parameters: ``pool`` inputs, cycled; ``sync_every`` calls between
waits; ``sample_gap``, the mean gap between calls whose answers are kept for
the check; ``profile_steps``, the calls of the traced stretch."""

from __future__ import annotations

import time
from contextlib import nullcontext

from torch.profiler import record_function

from bench.harness.profile import profile_stretch
from bench.harness.window import Window, sync


def warm(system, mix: dict) -> None:
    """Every pooled input once, then a wait: the shapes the window uses."""
    for x in system.pool:
        system.step(x)
    sync(system.device)


def run(system, mix: dict, end, sampler, timed_calls: bool) -> Window:
    pool, step, device = system.pool, system.step, system.device
    n_pool, every = len(pool), int(mix["sync_every"])
    samples, dispatch, i = [], 0.0, 0
    clock = time.perf_counter
    sync(device)
    t0 = end.open()
    while True:
        for _ in range(every):
            if timed_calls:
                a = clock()
                out = step(pool[i % n_pool])
                dispatch += clock() - a
            else:
                out = step(pool[i % n_pool])
            if i == sampler.next:
                samples.append((i % n_pool, out))
                sampler.advance()
            i += 1
        sync(device)
        t = clock()
        if end.over(t):
            break
    if not samples or samples[-1][1] is not out:
        samples.append(((i - 1) % n_pool, out))  # the window's last answer
    return Window("stream", t - t0, i, i * system.products_per_step, end.energy_j,
                  dispatch_s=dispatch if timed_calls else None, samples=samples)


def profile(system, mix: dict):
    """``profile_steps`` calls in the window's own cadence, traced, then
    ``label_steps`` with the host's parts named (``harness/profile.py``),
    after one more pass of the pool."""
    pool, step, device = system.pool, system.step, system.device
    every = int(mix["sync_every"])

    def stretch(steps, annotate):
        call = (lambda: record_function("bench.call")) if annotate else nullcontext
        wait = (lambda: record_function("bench.wait")) if annotate else nullcontext
        for i in range(steps):
            with call():
                step(pool[i % len(pool)])
            if (i + 1) % every == 0 or i + 1 == steps:
                with wait():
                    sync(device)

    warm(system, mix)
    return profile_stretch(stretch, device, int(mix["profile_steps"]), int(mix["label_steps"]))
