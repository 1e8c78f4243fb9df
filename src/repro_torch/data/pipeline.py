"""Synthetic LM data pipeline: stateless, step-indexed, host-prefetched.

Fault-tolerance property: ``batch_at(step)`` is a pure function of
(seed, step), so a restarted or elastically-rescaled job resumes mid-stream
with zero pipeline state in the checkpoint. Batches follow a Zipf unigram
draw with short-range repetition structure, so small-model training loss
visibly decreases (the end-to-end example's acceptance check).

Pure numpy, the reference's own code: ``batch_at(step)`` gives the same
bits in both packages for every ``(seed, step)``; the trainer moves each
batch to its device (``train.trainer.Trainer.to_device``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.35  # P(copy an earlier token) — learnable structure
    embed_dim: int = 0  # >0: also emit stub frontend embeddings
    prefix_len: int = 0


class SyntheticLMDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed unigram distribution (shared across steps)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, T = cfg.global_batch, cfg.seq_len
        base = self._perm[rng.choice(cfg.vocab_size, size=(B, T + 1), p=self._probs)]
        # repetition structure: some tokens copy a recent one (lag 1..8)
        rep = rng.random((B, T + 1)) < cfg.repeat_p
        lag = rng.integers(1, 9, size=(B, T + 1))
        idx = np.maximum(np.arange(T + 1)[None, :] - lag, 0)
        copied = np.take_along_axis(base, idx, axis=1)
        seq = np.where(rep, copied, base).astype(np.int32)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if cfg.embed_dim:
            # stub frontend: embeddings derived deterministically from ids
            emb_rng = np.random.default_rng((cfg.seed, step, 7))
            batch["embeds"] = emb_rng.normal(
                0, 0.02, size=(B, T, cfg.embed_dim)
            ).astype(np.float32)
        if cfg.prefix_len:
            pre_rng = np.random.default_rng((cfg.seed, step, 11))
            batch["prefix_embeds"] = pre_rng.normal(
                0, 0.02, size=(B, cfg.prefix_len, cfg.embed_dim or 1)
            ).astype(np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Host-side background prefetch (overlaps data gen with compute)."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0, depth: int = 2):
        self._ds = dataset
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._ds.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
