"""What a client loop hands back from the measured window, and the parts
every loop shares: the sample of answers kept for the check, and the wait
for the device."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench.harness.seeds import subseed


@dataclass
class Window:
    client: str
    seconds: float  # host clock, first call to the last answer
    steps: int
    products: int
    energy_j: float | None  # the board's counter across the window
    latencies_s: list | None = None  # per request, where the client waits for each
    dispatch_s: float | None = None  # host time inside the program's calls (traced runs)
    samples: list = field(default_factory=list)  # (pool index, outputs), in call order


class Sampler:
    """Which calls' answers are kept: gaps drawn from the seed, uniform on
    ``[1, 2 * gap)``, so that a run keeps about ``steps / gap`` answers
    spread over the whole window and over the pool."""

    def __init__(self, seed: int, gap: int):
        self._rng = np.random.default_rng(subseed(seed, "sample"))
        self._gap = int(gap)
        self.next = int(self._rng.integers(0, self._gap))

    def advance(self) -> None:
        self.next += int(self._rng.integers(1, 2 * self._gap))


class WindowEnd:
    """When the window opens and closes. Where the board's energy counter is
    read, both ends fall on its ticks (it moves every 100 ms on the H100), so
    its rise covers the window: the window opens at a tick, and once
    ``seconds`` have passed it closes at the next tick, calls going on until
    then and counting."""

    def __init__(self, seconds: float, energy):
        self.seconds, self.energy = float(seconds), energy
        self._mark = self._e0 = self._e1 = None

    def open(self) -> float:
        if self.energy is not None:
            self._e0 = self.energy.wait_tick()
        self.t0 = time.perf_counter()
        return self.t0

    def over(self, t: float) -> bool:
        if t - self.t0 < self.seconds:
            return False
        if self.energy is None:
            return True
        v = self.energy.read_j()
        if self._mark is None:
            self._mark = v
        elif v != self._mark:
            self._e1 = v
            return True
        return False

    @property
    def energy_j(self) -> float | None:
        return None if self._e1 is None else self._e1 - self._e0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
