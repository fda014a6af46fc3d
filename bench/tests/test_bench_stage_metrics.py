"""The readers of the engine's stage stamps (``bench/metrics``): each on a
synthetic window, on a window of a program without the stamps (silent), and
in a traced CPU run of the cells that list them."""
from __future__ import annotations

import pytest

from bench.lib import cell as cell_mod
from bench.lib import spec

STAGE_READERS = {
    "stack_ms_per_batch": "stack",
    "h2d_ms_per_batch": "h2d",
    "d2h_ms_per_batch": "d2h",
    "nan_scan_ms_per_batch": "nan_scan",
    "select_ms_per_batch": "select",
}


def _run(counters=None, hist=None):
  return cell_mod.RunData(
      workload="synthetic", config={}, traffic={}, seconds=10.0, t0=0.0,
      t1=10.0, obs=[], wrong=set(), squarings={}, counters=counters or {},
      hist=hist or {}, records=[], max_batch=8)


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_a_stage_reader_averages_its_histograms_over_every_bucket(name):
  window = STAGE_READERS[name]
  hist = {("closure/minplus/4096/float32", window): (0.9, 3),
          ("knn/addnorm/4096x16384x16/float32", window): (0.3, 1),
          ("closure/minplus/4096/float32", "host"): (50.0, 4),
          ("closure/minplus/4096/float32", "sync"): (7.0, 24)}
  got = spec.metric_reader(name)(_run(hist=hist))
  assert got == pytest.approx(1e3 * 1.2 / 4)


@pytest.mark.parametrize("name", sorted(STAGE_READERS) + ["syncs_per_batch"])
def test_a_program_without_stage_stamps_leaves_the_metric_out(name):
  """The parent of the stamps: host and device histograms, no stage ones,
  no ``syncs`` counter."""
  run = _run(counters={"batches": 57, "completed": 456, "h2d_bytes": 1},
             hist={("closure/minplus/4096/float32", "host"): (16.6, 57),
                   ("closure/minplus/4096/float32", "device"): (30.0, 57)})
  assert spec.metric_reader(name)(run) is None


def test_syncs_per_batch_reads_the_counters():
  read = spec.metric_reader("syncs_per_batch")
  assert read(_run(counters={"syncs": 456, "batches": 57})) == 8.0
  assert read(_run(counters={"syncs": 0, "batches": 57})) is None
  assert read(_run(counters={"syncs": 3, "batches": 0})) is None


@pytest.mark.parametrize("workload", ["apsp-bulk", "knn-bulk"])
def test_a_traced_run_reads_the_stage_metrics_of_its_cell(small_cell,
                                                         workload):
  res = cell_mod.run_cell(small_cell(workload), seed=2 ** 31 + 11,
                          seconds=1.5, trace=True, device="cpu",
                          log=lambda msg: None)
  assert res["correct"], res["checks"]
  listed = {m.name for m in spec.load_cell(workload).per_layer
            if m.name in STAGE_READERS or m.name == "syncs_per_batch"}
  want = {"stack_ms_per_batch", "h2d_ms_per_batch", "d2h_ms_per_batch",
          "nan_scan_ms_per_batch"}
  want |= {"syncs_per_batch"} if workload == "apsp-bulk" else {
      "select_ms_per_batch"}
  assert listed == want
  assert want <= set(res["metrics"])
  for name in want:
    assert res["metrics"][name]["value"] > 0.0, name
  if workload == "apsp-bulk":
    # a closure batch: a check before each squaring, one that sees none
    # changing (unless the budget ends it), then two output copies
    assert res["metrics"]["syncs_per_batch"]["value"] >= 3.0
