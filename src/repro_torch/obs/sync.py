"""Live fleet telemetry sync: one shared bandit posterior across instances.

The ROADMAP's fleet-scale item asks for telemetry that "aggregates across
server instances so the fleet shares one bandit posterior instead of
relearning per process". ``obs/aggregate.py`` merges shards *offline*; this
module closes the live loop:

* ``posterior_lines`` / ``calibration_lines`` serialize the
  ``AdaptiveFormatSelector`` posterior (per-cell arm pulls + measured mean
  values, plus the cell's incumbent) and the recorder's calibration pairs
  as ``kind``-discriminated JSONL records in the metrics shard schema, so
  a fleet shard drops straight into ``merge_shards``;
* ``FleetSync`` periodically writes this instance's shard into a shared
  ``--fleet-dir`` (atomic replace — peers never see torn shards) and folds
  every peer shard back into the local selector via
  ``AdaptiveFormatSelector.absorb``, then ``reconcile``s each touched cell:
  if the fleet's combined evidence beats the local incumbent by the drift
  margin, the measured-best format is promoted and the session's cached
  plans for that cell are dropped.

Exported shards carry only *locally measured* pulls (absorbed peer evidence
stays in the arms' ``absorbed_*`` fields), so the merged fleet posterior's
pull counts are exactly the sum over instances — syncing is idempotent and
evidence never echoes back amplified.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.obs.aggregate import read_shard_lines
from repro_torch.obs.metrics import METRICS_SCHEMA_VERSION, get_metrics
from repro_torch.utils.io import atomic_write_text
from repro_torch.utils.logging import get_logger

log = get_logger("obs.sync")

POSTERIOR_KIND = "posterior"
CALIBRATION_KIND = "calibration"

# calibration pairs shipped per format per shard: enough for a peer to seed
# a fit, small enough that shards stay scrape-sized
MAX_SYNC_PAIRS = 64


def posterior_lines(selector, instance: str = "") -> list[str]:
    """One JSONL record per locally-measured arm of every bandit cell."""
    lines = []
    for (bucket, objective), cell in sorted(selector.cells().items()):
        for fmt, arm in sorted(cell.arms.items()):
            if not arm.pulls:  # locally measured evidence only — no echo
                continue
            lines.append(
                json.dumps(
                    {
                        "kind": POSTERIOR_KIND,
                        "bucket": bucket,
                        "objective": objective,
                        "fmt": fmt,
                        "pulls": arm.pulls,
                        "value": arm.stats.mean,
                        "incumbent": cell.incumbent,
                        "instance": instance,
                    },
                    sort_keys=True,
                )
            )
    return lines


def calibration_lines(
    recorder, instance: str = "", max_pairs: int = MAX_SYNC_PAIRS
) -> list[str]:
    """One JSONL record per format with its recent calibration pairs."""
    lines = []
    for fmt, pairs in sorted(recorder.calibration_samples().items()):
        if not pairs:
            continue
        lines.append(
            json.dumps(
                {
                    "kind": CALIBRATION_KIND,
                    "fmt": fmt,
                    "pairs": [[p, m] for p, m in pairs[-max_pairs:]],
                    "instance": instance,
                },
                sort_keys=True,
            )
        )
    return lines


def write_fleet_shard(
    path: str | Path,
    *,
    selector=None,
    recorder=None,
    registry=None,
    instance: str = "",
) -> Path:
    """Write one self-contained fleet shard (metrics + posterior +
    calibration records) with an atomic replace, so concurrently-reading
    peers only ever see a complete shard."""
    path = Path(path)
    if registry is not None:
        lines = registry.shard_lines(instance)  # includes the meta header
    else:
        lines = [
            json.dumps(
                {
                    "kind": "meta",
                    "schema": METRICS_SCHEMA_VERSION,
                    "instance": instance,
                    "ts": time.time(),
                },
                sort_keys=True,
            )
        ]
    if selector is not None:
        lines.extend(posterior_lines(selector, instance))
    if recorder is not None:
        lines.extend(calibration_lines(recorder, instance))
    atomic_write_text(path, "\n".join(lines) + "\n")
    return path


class FleetSync:
    """Periodic export + peer absorption bound to one serving session."""

    def __init__(
        self,
        session,
        fleet_dir: str | Path,
        *,
        instance: str = "serve",
        sync_every: int = 0,
        registry=None,
    ):
        if session.adaptive is None:
            raise ValueError(
                "FleetSync needs a session with an AdaptiveFormatSelector "
                "(the posterior is what the fleet shares)"
            )
        self.session = session
        self.fleet_dir = Path(fleet_dir)
        self.fleet_dir.mkdir(parents=True, exist_ok=True)
        self.instance = instance
        self.sync_every = int(sync_every)
        self.registry = registry if registry is not None else get_metrics()
        self.syncs = 0
        self.promotions = 0
        self.last: dict = {}
        self._since = 0

    @property
    def shard_path(self) -> Path:
        return self.fleet_dir / f"shard-{self.instance}.jsonl"

    # ------------------------------------------------------------------ sync
    def maybe_sync(self, served: int = 1) -> dict | None:
        """Count served requests; run a full sync every ``sync_every``."""
        if self.sync_every <= 0:
            return None
        self._since += served
        if self._since < self.sync_every:
            return None
        self._since = 0
        return self.sync()

    def sync(self) -> dict:
        """Export the local shard, absorb every peer shard, reconcile."""
        self.export()
        stats = self.absorb_peers()
        self.syncs += 1
        self.registry.counter("fleet_syncs_total").inc()
        self.last = stats
        log.info(
            "fleet sync #%d [%s]: %d peer shard(s), %d arm(s) absorbed, "
            "%d promotion(s)",
            self.syncs, self.instance, stats["peers"],
            stats["arms_absorbed"], stats["promotions"],
        )
        return stats

    def export(self) -> Path:
        return write_fleet_shard(
            self.shard_path,
            selector=self.session.adaptive,
            recorder=self.session.telemetry,
            registry=self.registry,
            instance=self.instance,
        )

    def absorb_peers(self) -> dict:
        """Fold every peer shard's posterior into the local selector.

        Peer totals are recomputed from the current shard set each call and
        installed via the ``absorb`` setter, so repeated absorption is
        idempotent. Cells whose combined evidence overturns the local
        incumbent are promoted and their cached plans invalidated."""
        peers = [
            p
            for p in sorted(self.fleet_dir.glob("shard-*.jsonl"))
            if p != self.shard_path
        ]
        merged: dict[tuple[str, str, str], list[float]] = {}
        dropped = 0
        if peers:
            records, dropped = read_shard_lines(peers)
            for rec in records:
                if rec.get("kind") != POSTERIOR_KIND:
                    continue
                try:
                    pulls = int(rec["pulls"])
                    value = float(rec["value"])
                    key = (str(rec["bucket"]), str(rec["objective"]), str(rec["fmt"]))
                except (KeyError, TypeError, ValueError):
                    dropped += 1
                    continue
                if pulls <= 0 or value <= 0:
                    continue
                cell = merged.setdefault(key, [0, 0.0])
                cell[0] += pulls
                cell[1] += value * pulls
        selector = self.session.adaptive
        promotions = 0
        touched: set[tuple[str, str]] = set()
        for (bucket, objective, fmt), (pulls, weighted) in merged.items():
            selector.absorb(
                bucket, objective, fmt, pulls=int(pulls), value=weighted / pulls
            )
            touched.add((bucket, objective))
        for bucket, objective in sorted(touched):
            promoted = selector.reconcile(bucket, objective)
            if promoted is not None:
                self.session.invalidate(bucket, objective)
                promotions += 1
                self.registry.counter("fleet_promotions_total").inc()
                log.info(
                    "fleet evidence promoted %s for bucket=%s objective=%s",
                    promoted, bucket, objective,
                )
        self.promotions += promotions
        self.registry.gauge("fleet_peer_shards").set(len(peers))
        self.registry.gauge("fleet_absorbed_arms").set(len(merged))
        return {
            "peers": len(peers),
            "arms_absorbed": len(merged),
            "promotions": promotions,
            "dropped_lines": dropped,
        }

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        return {
            "instance": self.instance,
            "fleet_dir": str(self.fleet_dir),
            "sync_every": self.sync_every,
            "syncs": self.syncs,
            "promotions": self.promotions,
            "last": dict(self.last),
        }
