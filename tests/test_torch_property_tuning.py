"""The reference's cost-table properties (tests/test_property_tuning.py)
on the port's ``tuning`` package, with the reference's strategies,
``max_examples`` and ``deadline=None``.

The dispatch invariant a shipped ``cost_table.json`` rests on: serializing a
table and loading it back must not change a single dispatch decision —
otherwise a warmed table behaves differently in the serving job that loads
it than in the autotune run that wrote it.

``hypothesis`` is an optional test dependency (see pyproject.toml); the
module skips cleanly when it is not installed.
"""
import json
import math
import os
import tempfile

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import ALL_OPS  # noqa: E402
from repro_torch.tuning import (CostTable, DEFAULT_CONFIGS,  # noqa: E402
                                SCHEDULE_ARMS, resolve)

_BACKENDS = tuple(DEFAULT_CONFIGS)
_DTYPES = ("float32", "float16", "bool")
_MESH = (2, 4)

_ops = st.sampled_from(sorted(ALL_OPS))
_dims = st.integers(min_value=1, max_value=300)
_seconds = st.floats(min_value=1e-9, max_value=1e3,
                     allow_nan=False, allow_infinity=False)
_sources = st.sampled_from(("measured", "prior"))


@st.composite
def _entries(draw):
  """One valid table row: a local backend row (with one of its swept block
  configs, or none) or a distributed-schedule mesh row (cfg = mesh shape)."""
  op = draw(_ops)
  shape = (draw(_dims), draw(_dims), draw(_dims))
  dtype = draw(st.sampled_from(_DTYPES))
  if draw(st.booleans()):
    backend = draw(st.sampled_from(_BACKENDS))
    cfg = draw(st.sampled_from(DEFAULT_CONFIGS[backend] + ((),)))
  else:
    backend = draw(st.sampled_from(SCHEDULE_ARMS))
    cfg = _MESH
  return (op, shape, dtype, backend, cfg, draw(_seconds), draw(_sources))


@st.composite
def _tables(draw):
  table = CostTable(device=draw(st.sampled_from(("test", "cpu", "v5e"))))
  for row in draw(st.lists(_entries(), min_size=0, max_size=24)):
    op, shape, dtype, backend, cfg, seconds, source = row
    table.record(op, shape, dtype, backend, cfg, seconds, source=source)
  return table


def _probe_points(table):
  """Every (op, bucketed shape, dtype) the table holds rows for — the only
  points where a round-trip could possibly change a decision — plus one
  point no table ever holds (the both-sides-fall-to-prior case)."""
  points = set()
  for sig in table.entries:
    op, shape_s, dtype, _, _ = sig.split("|")
    m, k, n = (int(d) for d in shape_s.split("x"))
    points.add((op, (m, k, n), dtype))
  points.add(("mma", (8, 8, 8), "float32"))
  return sorted(points, key=repr)


@settings(max_examples=40, deadline=None)
@given(_tables())
def test_round_trip_preserves_entries_exactly(table):
  """to_json → from_json is the identity on the entry dict (float seconds
  survive bit-exact — json repr round-trips IEEE doubles)."""
  loaded = CostTable.from_json(table.to_json())
  assert loaded.device == table.device
  assert loaded.entries.keys() == table.entries.keys()
  for sig, entry in table.entries.items():
    got = loaded.entries[sig]
    assert got.seconds == entry.seconds and got.source == entry.source
  # and serialization is deterministic (sorted keys): stable artifact diffs
  assert loaded.to_json() == table.to_json()


@settings(max_examples=40, deadline=None)
@given(_tables())
def test_round_trip_preserves_resolve_decisions(table):
  """save → load must preserve every dispatch decision: same backend, same
  block config, same seconds, same measured/prior provenance — for the
  local argmin and for the mesh-arm competition."""
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "cost_table.json")
    table.save(path)
    loaded = CostTable.load(path)
  for op, (m, k, n), dtype in _probe_points(table):
    before = resolve(op, m, k, n, dtype, table=table)
    after = resolve(op, m, k, n, dtype, table=loaded)
    assert after == before, (op, (m, k, n), dtype)
    before_m = resolve(op, m, k, n, dtype, table=table, mesh_shape=_MESH)
    after_m = resolve(op, m, k, n, dtype, table=loaded, mesh_shape=_MESH)
    # prior seconds are recomputed, not stored; compare the decision fields
    assert (after_m.backend, after_m.cfg, after_m.source) == \
        (before_m.backend, before_m.cfg, before_m.source), (op, (m, k, n))
    if math.isfinite(before_m.seconds):
      assert after_m.seconds == pytest.approx(before_m.seconds)


@settings(max_examples=25, deadline=None)
@given(_tables())
def test_round_trip_preserves_best_per_backend(table):
  """The fixed-backend read path (``best(backends=(b,))`` — what a fixed
  ``backend=`` engine prices admission with) survives the round trip too."""
  loaded = CostTable.from_json(table.to_json())
  for op, (m, k, n), dtype in _probe_points(table):
    for backend in _BACKENDS:
      assert (loaded.best(op, (m, k, n), dtype, backends=(backend,))
              == table.best(op, (m, k, n), dtype, backends=(backend,)))


def test_from_json_rejects_corrupt_documents():
  """Non-property guardrails stay pinned alongside (runs without
  hypothesis installed too — importorskip already fired, but these four
  asserts document the validation surface the properties lean on)."""
  t = CostTable(device="test")
  t.record("mma", (16, 16, 16), "float32", "xla", (512,), 1e-3)
  doc = json.loads(t.to_json())
  bad_version = dict(doc, schema_version=999)
  with pytest.raises(ValueError, match="schema_version"):
    CostTable.from_json(json.dumps(bad_version))
  sig = next(iter(doc["entries"]))
  bad_source = json.loads(json.dumps(doc))
  bad_source["entries"][sig]["source"] = "vibes"
  with pytest.raises(ValueError, match="source"):
    CostTable.from_json(json.dumps(bad_source))
  bad_seconds = json.loads(json.dumps(doc))
  bad_seconds["entries"][sig]["seconds"] = -1.0
  with pytest.raises(ValueError, match="seconds"):
    CostTable.from_json(json.dumps(bad_seconds))
