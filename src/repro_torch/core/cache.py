"""Persistent feature-bucketed tuning cache (the session substrate).

Auto-SpMV's economics (paper §5.3) only work if the tuning decision is paid
once and amortized: the cache maps a quantized sparsity-feature *bucket* to
the plan the predictors produced for it — the kernel schedule (compile-time
mode) or the chosen format + gain/overhead estimates (run-time mode).
Matrices whose Table-2 feature vectors round to the same bucket share one
plan; since the predictors themselves only see (log-scaled) features, equal
buckets get near-identical predictions anyway, so the cache trades an
epsilon of decision resolution for skipping both model inferences entirely.

Entries are plain JSON: ``save``/``load`` round-trips survive process
restarts, so a serving fleet warms its schedule decisions from disk. The
prepared kernels themselves are process-local (device buffers) and
live in the ``kernels.ops`` keyed memo, not here.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.core.features import SparsityFeatures
from repro_torch.kernels.common import KernelSchedule
from repro_torch.obs.metrics import get_metrics
from repro_torch.utils.io import atomic_write_text
from repro_torch.utils.logging import get_logger

log = get_logger("core.cache")

# process-wide plan-cache counters: instrument handles are module-cached so
# the hot path pays one enabled-check + one add, nothing else
_HITS = get_metrics().counter("spmv_cache_hits_total")
_MISSES = get_metrics().counter("spmv_cache_misses_total")
_INVALIDATED = get_metrics().counter("spmv_cache_invalidations_total")

CACHE_FORMAT_VERSION = 1

# Bucket width in log1p feature units. 0.5 ≈ a 1.65x multiplicative band per
# feature: coarse enough that re-generated instances of the same matrix
# family collapse, fine enough that Fig.-7-dissimilar matrices stay apart.
DEFAULT_BUCKET_RESOLUTION = 0.5


def feature_bucket(
    feats: SparsityFeatures, resolution: float = DEFAULT_BUCKET_RESOLUTION
) -> str:
    """Quantize the log-feature vector into a stable string key."""
    q = np.floor(feats.log_vector() / resolution + 0.5).astype(np.int64)
    return "b" + "_".join(str(int(v)) for v in q)


@dataclass
class CacheEntry:
    """One cached tuning decision for a (bucket, objective, mode) key.

    ``mode`` is ``"compile"``, ``"run:<current_format>"`` — run-time plans
    depend on the format currently held, so it is part of the identity — or
    ``"part:max<k>"`` for partitioned composite plans (the block-count
    budget is part of the key, so sessions with different ``--max-blocks``
    never alias).
    """

    bucket: str
    objective: str
    mode: str
    fmt: str  # chosen format ("csr" in compile mode; "+".joined per-block
    # formats for partitioned entries)
    schedule: dict  # KernelSchedule.as_dict()
    predicted: dict[str, float] = field(default_factory=dict)
    gain_per_iter: float = 0.0
    latency_gain_per_iter: float = 0.0
    overhead_s: float = 0.0  # full predicted f + c + o + p at plan time
    convert_overhead_s: float = 0.0  # the c term alone: re-charged on hits
    # whose prepared kernel is not in the process memo (fresh process /
    # different matrix in the same bucket)
    hits: int = 0
    # partitioned composite plans (repro_torch.partition): chosen block count and
    # the per-block decisions ({"fmt", "schedule", "latency"} dicts, in row
    # order). Bucket-mates replay these onto their own nnz-balanced row
    # boundaries — the *decisions* are bucket-level, the boundaries are not.
    n_blocks: int = 1
    blocks: list = field(default_factory=list)
    monolithic_fmt: str = ""  # the single-format baseline the plan beat

    def kernel_schedule(self) -> KernelSchedule:
        return KernelSchedule(**self.schedule)


class TuningCache:
    """In-memory map of tuning decisions with JSON persistence."""

    def __init__(self, resolution: float = DEFAULT_BUCKET_RESOLUTION):
        self.resolution = float(resolution)
        self._entries: dict[tuple[str, str, str], CacheEntry] = {}
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ keys
    def bucket_of(self, feats: SparsityFeatures) -> str:
        return feature_bucket(feats, self.resolution)

    @staticmethod
    def _key(bucket: str, objective: str, mode: str) -> tuple[str, str, str]:
        return (bucket, objective, mode)

    # ---------------------------------------------------------------- access
    def get(self, bucket: str, objective: str, mode: str) -> CacheEntry | None:
        entry = self._entries.get(self._key(bucket, objective, mode))
        if entry is None:
            self.misses += 1
            _MISSES.inc()
            return None
        self.hits += 1
        _HITS.inc()
        entry.hits += 1
        return entry

    def put(self, entry: CacheEntry) -> CacheEntry:
        self._entries[self._key(entry.bucket, entry.objective, entry.mode)] = entry
        return entry

    def peek(self, bucket: str, objective: str, mode: str) -> CacheEntry | None:
        """get() without touching hit/miss accounting (for introspection)."""
        return self._entries.get(self._key(bucket, objective, mode))

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple[str, str, str]) -> bool:
        return key in self._entries

    def entries(self) -> list[CacheEntry]:
        return list(self._entries.values())

    def invalidate(
        self,
        bucket: str,
        objective: str | None = None,
        mode: str | None = None,
    ) -> int:
        """Drop entries matching ``bucket`` (and, if given, objective/mode).

        The telemetry layer's drift detector calls this when measured
        behavior contradicts a cached plan: the stale decision is evicted so
        the next request re-plans against the (refit) predictors. Returns
        the number of entries removed.
        """
        doomed = [
            k
            for k in self._entries
            if k[0] == bucket
            and (objective is None or k[1] == objective)
            and (mode is None or k[2] == mode)
        ]
        for k in doomed:
            del self._entries[k]
        if doomed:
            _INVALIDATED.inc(len(doomed))
            log.info(
                "invalidated %d plan(s) for bucket=%s objective=%s mode=%s",
                len(doomed),
                bucket,
                objective or "*",
                mode or "*",
            )
        return len(doomed)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = self.misses = 0

    def stats(self) -> dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}

    # ----------------------------------------------------------- persistence
    def save(self, path: str | Path) -> Path:
        path = Path(path)
        payload = {
            "version": CACHE_FORMAT_VERSION,
            "resolution": self.resolution,
            "entries": [asdict(e) for e in self._entries.values()],
        }
        # temp file + os.replace: an interrupted save must not corrupt the
        # cache a restarting fleet would otherwise warm from
        atomic_write_text(path, json.dumps(payload, indent=1))
        log.info("saved %d cache entries to %s", len(self._entries), path)
        return path

    @classmethod
    def load(cls, path: str | Path) -> "TuningCache":
        payload = json.loads(Path(path).read_text())
        if payload.get("version") != CACHE_FORMAT_VERSION:
            raise ValueError(
                f"cache version {payload.get('version')!r} != {CACHE_FORMAT_VERSION}"
            )
        cache = cls(resolution=payload["resolution"])
        for raw in payload["entries"]:
            cache.put(CacheEntry(**raw))
        log.info("loaded %d cache entries from %s", len(cache), path)
        return cache
