"""The harness finds every configuration, mix and metric by name."""
from __future__ import annotations

import json
import re

import pytest

from bench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_loads_its_files_by_name():
  bench = spec.load_benchmark()
  for w in bench["workloads"]:
    cell = spec.load_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.traffic["streams"]
    assert "setup_s" in {m.name for m in cell.end_to_end}
    assert cell.per_layer, w["name"]
    for m in cell.per_layer:
      assert callable(spec.metric_reader(m.name))


def test_names_units_and_keys_keep_to_the_contract():
  bench = spec.load_benchmark()
  for entry in (bench["configs"] + bench["workloads"] + bench["end_to_end"]
                + bench["per_layer"]):
    assert NAME.match(entry["name"]), entry["name"]
  for m in bench["end_to_end"] + bench["per_layer"]:
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
  for m in bench["end_to_end"]:
    assert 0.01 <= m["bound"] <= 0.25
  e2e = {m["name"] for m in bench["end_to_end"]}
  for m in bench["per_layer"]:
    assert m["moves"] in e2e
  for c in bench["configs"]:
    assert c["file"].startswith("bench/configs/")


def test_an_unknown_name_is_refused():
  with pytest.raises(KeyError):
    spec.load_cell("no-such-cell")
  with pytest.raises(ValueError):
    spec.metric_reader("../run")


def test_per_layer_metrics_go_to_the_cells_that_report_what_they_move():
  bench = spec.load_benchmark()
  for w in bench["workloads"]:
    cell = spec.load_cell(w["name"])
    reported = {m.name for m in cell.end_to_end}
    for m in cell.per_layer:
      assert m.moves in reported
  assert json.dumps(bench)  # plain JSON
