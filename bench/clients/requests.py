"""One closed-loop client on the host: each request hands the program a
pooled host input, and the client waits for the answer back on the host
before it sends the next (a host-side solver calling a plan). A request's
latency runs from the call to the answer on the host: the copy in, the
program's call, the product and the copy out.

Mix parameters: ``pool`` host inputs, cycled; ``sample_gap``, the mean gap
between requests whose answers are kept for the check; ``profile_steps``,
the requests of the traced stretch."""

from __future__ import annotations

import time
from contextlib import nullcontext

from torch.profiler import record_function

from bench.harness.profile import profile_stretch
from bench.harness.window import Window, sync


def _to_host(outs):
    return tuple(o.cpu() for o in outs)


def warm(system, mix: dict) -> None:
    for x in system.pool:
        _to_host(system.step(x))


def run(system, mix: dict, end, sampler, timed_calls: bool) -> Window:
    pool, step, device = system.pool, system.step, system.device
    n_pool = len(pool)
    samples, latencies, dispatch, i = [], [], 0.0, 0
    clock = time.perf_counter
    sync(device)
    t0 = end.open()
    while True:
        x = pool[i % n_pool]
        a = clock()
        outs = step(x)
        if timed_calls:
            dispatch += clock() - a
        host = _to_host(outs)
        b = clock()
        latencies.append(b - a)
        if i == sampler.next:
            samples.append((i % n_pool, host))
            sampler.advance()
        i += 1
        if end.over(b):
            break
    if not samples or samples[-1][1] is not host:
        samples.append(((i - 1) % n_pool, host))
    return Window("requests", b - t0, i, i * system.products_per_step, end.energy_j,
                  latencies_s=latencies,
                  dispatch_s=dispatch if timed_calls else None, samples=samples)


def profile(system, mix: dict):
    """``profile_steps`` requests traced, then ``label_steps`` with the
    host's parts named (``harness/profile.py``), after one more pass of the
    pool."""
    pool, step, device = system.pool, system.step, system.device

    def stretch(steps, annotate):
        call = (lambda: record_function("bench.call")) if annotate else nullcontext
        back = (lambda: record_function("bench.answer_to_host")) if annotate else nullcontext
        for i in range(steps):
            with call():
                outs = step(pool[i % len(pool)])
            with back():
                _to_host(outs)

    warm(system, mix)
    return profile_stretch(stretch, device, int(mix["profile_steps"]), int(mix["label_steps"]))
