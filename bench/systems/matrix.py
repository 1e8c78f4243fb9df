"""A resident sparse matrix served by the port's compile-time mode.

Set-up draws the matrix and a pool of input vectors from the seed on the
device, builds the tuner as the configuration says, plans the matrix once
with ``AutoSpmvSession.serve_optimize`` and runs its first product; a step is
one ``PreparedSpmv.__call__`` on one vector of the pool.

The configuration's precision holds for the product: where the served
schedule accumulates otherwise, the plan's format and schedule are compiled
again with that precision through ``compile_spmv``, as the port's sparse
engine does for its plans (``force_fp32``). The control (``control=True``)
serves the plan's schedule with bfloat16 accumulation instead."""

from __future__ import annotations

import numpy as np
import torch

from bench.harness.seeds import subseed
from bench.harness.yardstick import spmv_call_work
from bench.reference.generate import dense_from_coo, symmetric_denserows_coo
from bench.reference.products import CsrReference

GENERATORS = {"denserows_symmetric": symmetric_denserows_coo}


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, *,
                 control: bool = False, tuner=None):
        if mix.get("tokens", 1) != 1:
            raise ValueError("a matrix is served one vector a call")
        if cfg["precision"] != "float32":
            raise ValueError(f"precision {cfg['precision']!r}: the kernels serve float32")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.tuner = tuner
        m = cfg["matrix"]
        self.shape = (int(m["n_rows"]), int(m["n_cols"]))
        if self.shape[0] != self.shape[1]:
            raise ValueError("a symmetric matrix is square")
        self.products_per_step = 1
        self.plan = None

    def inputs(self) -> None:
        """The matrix (positions and values, and the dense array the
        program takes) and the pool of vectors, drawn from the seed."""
        n = self.shape[0]
        gen = torch.Generator(self.device).manual_seed(subseed(self.seed, "matrix"))
        keys, vals = GENERATORS[self.cfg["matrix"]["family"]](
            n, int(self.cfg["matrix"]["nnz"]), gen, self.device)
        self.keys, self.vals = keys.cpu().numpy(), vals.cpu().numpy()
        self.dense = dense_from_coo(n, n, self.keys, self.vals)
        gen = torch.Generator(self.device).manual_seed(subseed(self.seed, "pool"))
        pool = torch.randn(int(self.mix["pool"]), self.shape[1], generator=gen, device=self.device)
        self.pool_host = pool.cpu().numpy()
        self.pool = list(pool.unbind(0)) if self.mix["x_on"] == "device" else list(self.pool_host)
        # bytes and operations a call needs, counted from the drawn matrix
        self.work = spmv_call_work(*self.shape, int(self.keys.size))

    def build_tuner(self):
        from repro_torch.core.session import build_tuner

        if self.tuner is None:
            self.tuner = build_tuner(device=self.device, **self.cfg["tuner"])
        return self.tuner

    def first_answer(self):
        """Plan the matrix, then its first product, synchronised."""
        from repro_torch.core.session import AutoSpmvSession
        from repro_torch.kernels.ops import compile_spmv

        self.session = AutoSpmvSession(self.tuner)
        plan = self.session.serve_optimize(self.dense, self.cfg["objective"])
        self.served_schedule = plan.schedule
        want = "bfloat16" if self.control else "float32"
        kernel = plan.kernel
        if plan.schedule.accum_dtype != want:
            kernel = compile_spmv(self.dense, plan.fmt, plan.schedule.replace(accum_dtype=want),
                                  device=self.tuner.device, memo_key=plan.fingerprint)
        self.plan, self.kernel = plan, kernel
        return self.step(self.pool[0])

    def step(self, x):
        return (self.kernel(x),)

    def describe(self) -> dict:
        s = self.served_schedule
        return {"format": self.plan.fmt, "schedule": s.as_dict(),
                "served_accum": self.kernel.schedule.accum_dtype,
                "nnz": int(self.keys.size)}

    def release(self) -> None:
        """Drop the program's state: its session, plans and kernels."""
        from repro_torch.kernels.ops import clear_kernel_memo

        self.session = self.plan = self.kernel = self.dense = None
        self.pool = None
        clear_kernel_memo()

    def reference(self, pool_index: int) -> tuple[np.ndarray]:
        """Once per pooled vector: every kept answer of it is held to the same."""
        if not hasattr(self, "_ref"):
            self._ref, self._ys = CsrReference(*self.shape, self.keys, self.vals), {}
        if pool_index not in self._ys:
            self._ys[pool_index] = self._ref @ self.pool_host[pool_index]
        return (self._ys[pool_index],)
