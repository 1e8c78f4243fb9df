"""Fleet aggregation: merge metric/trace JSONL shards from N instances.

Each serving instance exports its own shards (``MetricsRegistry.write_shard``
for metrics, ``Tracer.export_jsonl`` for spans); this module folds any
number of them into one report — the substrate the ROADMAP's fleet-scale
serving (shared bandit posteriors, cross-instance drift) needs before any
of that logic can exist. Merge semantics:

* counters — summed (fleet totals: cache hits, compiles, explore pulls);
* gauges   — averaged, with min/max retained (per-format power differs per
  instance; the report keeps the spread, not just one sample);
* histograms — counts and sums add, and percentiles are *recomputed over
  the concatenated recent windows* (averaging per-instance percentiles
  would be wrong for any skewed latency distribution);
* spans    — concatenated with their source instance attached, summarized
  per name (count, total/mean duration);
* posteriors (``obs/sync.py`` fleet shards) — per-(bucket, objective, fmt)
  arm pulls sum and values merge pull-weighted, with each instance's
  incumbent retained per cell (and a ``converged`` flag when they agree);
* calibration pairs — concatenated per format (bounded), with the fleet
  mean relative error recomputed over the merged pairs.

Lines that fail to parse (torn appends, foreign schemas) are counted and
skipped, matching the replay tolerance everywhere else in the repo.

CLI: ``python -m repro_torch.obs.aggregate shard1.jsonl shard2.jsonl -o report.json``
— shard kind (metrics vs. trace) is detected per line, so mixed file lists
are fine.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from repro_torch.utils.timing import percentile as _pctl
from repro_torch.obs.metrics import QUANTILES
from repro_torch.utils.logging import get_logger

log = get_logger("obs.aggregate")


def _labels_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def read_shard_lines(paths: list[str | Path]) -> tuple[list[dict], int]:
    """Parse every line of every shard; returns (records, dropped_lines).

    Reads line-by-line — a fleet of long-running instances produces shards
    far bigger than any single record, so the file never sits in memory
    whole. Torn lines (interrupted appends, foreign schemas) are counted
    and skipped, matching the replay tolerance everywhere else."""
    records, dropped = [], 0
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    dropped += 1
                    continue
                if isinstance(rec, dict):
                    rec.setdefault("_shard", str(path))
                    records.append(rec)
                else:
                    dropped += 1
    return records, dropped


def merge_shards(paths: list[str | Path]) -> dict:
    """Fold metric + trace shard files into one fleet report."""
    records, dropped = read_shard_lines(paths)
    instances: set[str] = set()
    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    hists: dict[str, dict] = {}
    spans: list[dict] = []
    posteriors: dict[tuple[str, str], dict] = {}
    calibration: dict[str, dict] = {}

    for rec in records:
        kind = rec.get("kind")
        if kind == "meta":
            if rec.get("instance"):
                instances.add(rec["instance"])
            continue
        if kind in ("counter", "gauge", "histogram"):
            if rec.get("instance"):
                instances.add(rec["instance"])
            key = _labels_key(rec.get("name", "?"), rec.get("labels") or {})
            if kind == "counter":
                counters[key] = counters.get(key, 0.0) + float(rec.get("value") or 0.0)
            elif kind == "gauge":
                v = rec.get("value")
                if v is None or (isinstance(v, float) and math.isnan(v)):
                    continue
                cell = gauges.setdefault(
                    key, {"sum": 0.0, "n": 0, "min": math.inf, "max": -math.inf}
                )
                cell["sum"] += float(v)
                cell["n"] += 1
                cell["min"] = min(cell["min"], float(v))
                cell["max"] = max(cell["max"], float(v))
            else:
                cell = hists.setdefault(
                    key, {"count": 0, "sum": 0.0, "recent": []}
                )
                cell["count"] += int(rec.get("count") or 0)
                cell["sum"] += float(rec.get("sum") or 0.0)
                cell["recent"].extend(float(x) for x in rec.get("recent") or ())
        elif kind == "posterior":  # obs/sync.py fleet-shard bandit arm
            if rec.get("instance"):
                instances.add(rec["instance"])
            try:
                pulls = int(rec["pulls"])
                value = float(rec["value"])
                key = (str(rec["bucket"]), str(rec["objective"]))
                fmt = str(rec["fmt"])
            except (KeyError, TypeError, ValueError):
                dropped += 1
                continue
            cell = posteriors.setdefault(key, {"arms": {}, "incumbents": {}})
            arm = cell["arms"].setdefault(fmt, {"pulls": 0, "weighted": 0.0})
            arm["pulls"] += pulls
            arm["weighted"] += value * pulls  # pull-weighted value merge
            if rec.get("instance") and rec.get("incumbent"):
                cell["incumbents"][rec["instance"]] = rec["incumbent"]
        elif kind == "calibration":  # obs/sync.py (predicted, measured) pairs
            if rec.get("instance"):
                instances.add(rec["instance"])
            fmt = str(rec.get("fmt", "?"))
            cell = calibration.setdefault(fmt, {"samples": 0, "pairs": []})
            for pair in rec.get("pairs") or ():
                try:
                    p, m = float(pair[0]), float(pair[1])
                except (TypeError, ValueError, IndexError):
                    dropped += 1
                    continue
                cell["samples"] += 1
                if len(cell["pairs"]) < 256:  # bound the merged window
                    cell["pairs"].append((p, m))
        elif "name" in rec and "dur_s" in rec:  # a trace span line
            span = dict(rec)
            span["instance"] = rec.get("instance") or rec.get("_shard", "")
            spans.append(span)
        else:
            dropped += 1

    report = {
        "shards": len(set(str(p) for p in paths)),
        "instances": sorted(instances),
        "dropped_lines": dropped,
        "counters": dict(sorted(counters.items())),
        "gauges": {
            k: {
                "mean": c["sum"] / c["n"],
                "min": c["min"],
                "max": c["max"],
                "instances": c["n"],
            }
            for k, c in sorted(gauges.items())
        },
        "histograms": {},
        "spans": _span_summary(spans),
    }
    for key, cell in sorted(hists.items()):
        merged = {
            "count": cell["count"],
            "sum": cell["sum"],
            "mean": cell["sum"] / cell["count"] if cell["count"] else math.nan,
        }
        for q in QUANTILES:
            merged[f"p{int(q)}"] = _pctl(cell["recent"], q)
        merged["window_samples"] = len(cell["recent"])
        report["histograms"][key] = merged
    if posteriors:
        out_post = {}
        for (bucket, objective), cell in sorted(posteriors.items()):
            arms = {
                fmt: {
                    "pulls": a["pulls"],
                    "value": a["weighted"] / a["pulls"] if a["pulls"] else math.nan,
                }
                for fmt, a in sorted(cell["arms"].items())
            }
            incumbents = dict(sorted(cell["incumbents"].items()))
            out_post[f"{bucket}|{objective}"] = {
                "arms": arms,
                "pulls": sum(a["pulls"] for a in arms.values()),
                "incumbents": incumbents,
                "converged": len(set(incumbents.values())) <= 1,
            }
        report["posteriors"] = out_post
    if calibration:
        out_cal = {}
        for fmt, cell in sorted(calibration.items()):
            pairs = cell["pairs"]
            rel = [abs(m - p) / p for p, m in pairs if p > 0]
            out_cal[fmt] = {
                "samples": cell["samples"],
                "window_pairs": len(pairs),
                "mean_rel_err": sum(rel) / len(rel) if rel else math.nan,
            }
        report["calibration"] = out_cal
    return report


def _span_summary(spans: list[dict]) -> dict:
    by_name: dict[str, dict] = {}
    for s in spans:
        cell = by_name.setdefault(s["name"], {"count": 0, "total_s": 0.0})
        cell["count"] += 1
        cell["total_s"] += float(s.get("dur_s") or 0.0)
    for cell in by_name.values():
        cell["mean_s"] = cell["total_s"] / cell["count"]
    return {
        "total": len(spans),
        "instances": sorted({s.get("instance", "") for s in spans} - {""}),
        "by_name": dict(sorted(by_name.items())),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("shards", nargs="+", help="metric/trace JSONL shard files")
    ap.add_argument("-o", "--out", default=None, help="write the merged report JSON here")
    args = ap.parse_args(argv)
    report = merge_shards(args.shards)
    text = json.dumps(report, indent=1, default=float)
    if args.out:
        from repro_torch.utils.io import atomic_write_text

        atomic_write_text(args.out, text)
        log.info(
            "merged %d shard(s) from %d instance(s) -> %s",
            report["shards"],
            len(report["instances"]),
            args.out,
        )
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
