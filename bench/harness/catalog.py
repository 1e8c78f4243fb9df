"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

Each part is a file of its own, so that a later change adds a configuration,
a traffic mix, a cell or a metric by adding files and entries alone:

* ``configs/<config>.json``: a configuration; its ``system`` key names the
  module ``systems/<system>.py`` that stands it up in the program;
* ``traffic/<traffic>.json``: a traffic mix's parameters; its ``client`` key
  names the loop ``clients/<client>.py`` that drives them;
* ``workloads/<cell>.json``: a cell's limits for the comparison that decides
  ``correct``;
* ``metrics/<metric>.py``: a metric's reader, ``read(run) -> float | None``;
  a metric ``<base>.<part>`` without a file of its own, split by the cells
  that report it, reads as ``<base>`` does.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_file(path: Path):
    """The Python file at ``path`` as a module of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    name = "bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple[str, ...] | None  # None: every cell that reports what it moves
    moves: str | None  # per-layer metrics: the end-to-end metric it moves
    end_to_end: bool


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Catalog:
    """``BENCHMARK.json`` and the files it names, under ``bench_dir``."""

    def __init__(self, spec: dict, bench_dir: Path = BENCH_DIR):
        self.spec = spec
        self.bench_dir = Path(bench_dir)
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
                      for w in spec["workloads"]}
        self.metrics = [self._metric(m, True) for m in spec["end_to_end"]]
        self.metrics += [self._metric(m, False) for m in spec["per_layer"]]

    @staticmethod
    def _metric(m: dict, end_to_end: bool) -> Metric:
        cells = m.get("workloads")
        return Metric(m["name"], m["unit"], m["better"], m["source"],
                      tuple(cells) if cells is not None else None, m.get("moves"), end_to_end)

    @classmethod
    def load(cls, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> "Catalog":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()), bench_dir)

    def cell(self, name: str) -> Cell:
        try:
            return self.cells[name]
        except KeyError:
            raise SystemExit(f"unknown workload {name!r}; have {sorted(self.cells)}") from None

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.bench_dir / kind / f"{name}.json").read_text())

    def config(self, cell: Cell) -> dict:
        return self._json("configs", cell.config)

    def traffic(self, cell: Cell) -> dict:
        return self._json("traffic", cell.traffic)

    def limits(self, cell: Cell) -> dict:
        return self._json("workloads", cell.name)

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` as a module (a name may hold dots)."""
        return load_file(self.bench_dir / kind / f"{name}.py")

    def reader(self, metric: str):
        """The ``read`` of ``metrics/<metric>.py``, or of the longest
        dotted prefix of the name that has a file."""
        name = metric
        while not (self.bench_dir / "metrics" / f"{name}.py").is_file() and "." in name:
            name = name.rsplit(".", 1)[0]
        return self.module("metrics", name).read

    def metrics_for(self, cell: Cell, trace: bool) -> list[Metric]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer ones.
        An end-to-end metric without ``workloads`` is every cell's; a
        per-layer one without it is every cell's that reports what it moves."""
        e2e = [m for m in self.metrics if m.end_to_end
               and (m.workloads is None or cell.name in m.workloads)]
        if not trace:
            return e2e
        moved = {m.name for m in e2e}
        return [m for m in self.metrics if not m.end_to_end and (
            cell.name in m.workloads if m.workloads is not None else m.moves in moved)]
