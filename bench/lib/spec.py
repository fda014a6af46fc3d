"""Find a cell's configuration, traffic mix and metric readers by name.

``BENCHMARK.json`` names every cell, configuration and metric; the files
that belong to each sit under ``bench/``:

  configs/<config name>.json    the deployment (request shape, engine
                                settings, the limits of the comparison)
  traffic/<traffic name>.json   the mix one general generator reads
  metrics/<metric name>.py      one reader per per-layer metric

A later cell, mix or metric is new files plus entries in ``BENCHMARK.json``:
nothing here branches on a name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass
class Metric:
  name: str
  unit: str
  better: str
  source: str
  workloads: tuple | None  # None: every cell that reports ``moves``
  moves: str | None = None

  def applies_to(self, workload: str) -> bool:
    return self.workloads is None or workload in self.workloads


@dataclasses.dataclass
class Cell:
  workload: str
  chips: int
  config: dict
  traffic: dict
  end_to_end: list
  per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
  path = root / "BENCHMARK.json"
  if not path.is_file():
    raise FileNotFoundError(f"no BENCHMARK.json at {root}")
  return json.loads(path.read_text())


def _metric(entry: dict) -> Metric:
  wl = entry.get("workloads")
  return Metric(name=entry["name"], unit=entry["unit"],
                better=entry["better"], source=entry["source"],
                workloads=None if wl is None else tuple(wl),
                moves=entry.get("moves"))


def _named_file(folder: Path, name: str, suffix: str) -> Path:
  if not NAME.match(name):
    raise ValueError(f"not a valid name: {name!r}")
  path = folder / f"{name}{suffix}"
  if not path.is_file():
    raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
  return path


def load_cell(workload: str, root: Path = ROOT) -> Cell:
  """The cell named ``workload``: its configuration and traffic files, and
  the metrics it reports (end-to-end with ``--trace 0``, per-layer with
  ``--trace 1``)."""
  bench = load_benchmark(root)
  cells = {w["name"]: w for w in bench["workloads"]}
  if workload not in cells:
    raise KeyError(f"unknown workload {workload!r}; one of {sorted(cells)}")
  w = cells[workload]
  configs = {c["name"]: c for c in bench["configs"]}
  cfg_entry = configs[w["config"]]
  config = json.loads((root / cfg_entry["file"]).read_text())
  traffic = json.loads(
      _named_file(root / "bench" / "traffic", w["traffic"], ".json")
      .read_text())
  e2e = [m for m in map(_metric, bench["end_to_end"])
         if m.applies_to(workload)]
  reported = {m.name for m in e2e}
  per_layer = [m for m in map(_metric, bench["per_layer"])
               if m.applies_to(workload) and m.moves in reported]
  return Cell(workload=workload, chips=int(w["chips"]), config=config,
              traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str, root: Path = ROOT):
  """The ``read(run)`` function of ``bench/metrics/<name>.py``."""
  path = _named_file(root / "bench" / "metrics", name, ".py")
  mod_name = "bench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
  spec = importlib.util.spec_from_file_location(mod_name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read
