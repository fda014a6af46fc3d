"""CPU tests of the benchmark (``python -m pytest -q bench/tests``).

The repository's own test run collects ``tests/`` only.  Nothing here needs
the card: the harness runs on the CPU with the program's plain arms at tiny
sizes (``small_cell``), and decides inside a test, never at import, what
it can run."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
  if str(p) not in sys.path:
    sys.path.insert(0, str(p))


def shrink(cell):
  """The cell's mix and configuration at a size a CPU run holds: the same
  streams, rings and engine settings, smaller problems, fewer clients."""
  req = cell.config["request"]
  if req["kind"] == "closure":
    req["n"] = 48
  else:
    req.update(queries=48, corpus=160)
  for st in cell.traffic["streams"]:
    if st["loop"] == "closed":
      st["clients"], st["pool"] = 4, 3
      st["check_share"] = 1.0
    else:
      st["request"]["n"] = [20, 32]
  return cell


@pytest.fixture
def small_cell():
  from bench.lib import spec

  def make(workload):
    return shrink(spec.load_cell(workload))

  return make
