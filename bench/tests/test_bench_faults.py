"""Whole runs of the harness on the CPU at small sizes (the program's plain
arms, the look for a card skipped): a sound run is correct, and the control
and each fault a serving cell can have make ``correct`` come out false.

The faults are planted underneath the harness, in the timed path:
  * a step that returns its state unchanged (the closure's fixpoint step);
  * half of the batch left out (the batch function fills only the first
    half of its slots; the rest stay zero);
  * an answer altered where it is produced (one entry of the batch's
    first answer).
The exchange between chips does not exist in these one-card cells."""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

from bench import control
from bench.lib import cell as cell_mod

SECONDS = 1.5


def _run(cell, seed=2 ** 31 + 5):
  return cell_mod.run_cell(cell, seed=seed, seconds=SECONDS, trace=False,
                           device="cpu", log=lambda msg: None)


@contextlib.contextmanager
def _wrapped_batch_fn(transform):
  from repro_torch.serve_mmo import batching
  orig = batching.make_batch_fn

  def make(key, **kw):
    fn = orig(key, **kw)

    def run(*args):
      return transform(key, fn(*args))

    return run

  batching.make_batch_fn = make
  try:
    yield
  finally:
    batching.make_batch_fn = orig


def _half_left_out(key, out):
  outs = list(out) if isinstance(out, (tuple, list)) else [out]
  half = (outs[0].shape[0] + 1) // 2
  outs = [o.clone() for o in outs]
  for o in outs:
    o[half:] = 0
  return tuple(outs) if isinstance(out, (tuple, list)) else outs[0]


def _altered(key, out):
  outs = [o.clone() for o in out]
  if key.kind == "closure":
    outs[0][0, 1, 2] += 1.0
  else:
    outs[1][0, 0, 0] = (outs[1][0, 0, 0] + 1) % 7
  return tuple(outs)


@contextlib.contextmanager
def _step_unchanged():
  from repro_torch.core import closure as cl
  orig = cl._fixpoint_step

  def step(state, step_fn):
    c, active, iters, valid_n = state
    return c, torch.zeros_like(active), iters + active.to(torch.int32), \
        valid_n

  cl._fixpoint_step = step
  try:
    yield
  finally:
    cl._fixpoint_step = orig


@pytest.mark.parametrize("workload", ["apsp-bulk", "knn-bulk", "apsp-urgent"])
def test_a_sound_run_is_correct(small_cell, workload):
  res = _run(small_cell(workload))
  assert res["correct"], res["checks"]
  assert res["attempted"] > 0 and res["failed"] == 0
  assert list(res)[-1] == "checks"
  names = set(res["metrics"])
  assert "setup_s" in names
  if workload == "apsp-urgent":
    assert names == {"urgent_p95_ms", "deadline_met_pct", "setup_s"}
  else:
    assert names == {"solves_per_s", "setup_s"}


@pytest.mark.parametrize("workload", ["apsp-bulk", "knn-bulk"])
def test_the_control_comes_out_not_correct(small_cell, workload):
  with control.installed():
    res = _run(small_cell(workload))
  assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,fault", [
    ("apsp-bulk", "step_unchanged"),
    ("apsp-bulk", "half_left_out"),
    ("apsp-bulk", "altered"),
    ("knn-bulk", "half_left_out"),
    ("knn-bulk", "altered"),
    ("apsp-urgent", "altered"),
])
def test_a_fault_in_the_timed_path_comes_out_not_correct(small_cell,
                                                        workload, fault):
  if fault == "step_unchanged":
    ctx = _step_unchanged()
  else:
    ctx = _wrapped_batch_fn({"half_left_out": _half_left_out,
                             "altered": _altered}[fault])
  with ctx:
    res = _run(small_cell(workload))
  assert not res["correct"], res["checks"]
  assert res["failed"] > 0


def test_a_traced_run_reads_the_per_layer_metrics_it_can(small_cell):
  res = cell_mod.run_cell(small_cell("apsp-bulk"), seed=3, seconds=SECONDS,
                          trace=True, device="cpu", log=lambda msg: None)
  assert res["correct"]
  assert {"batch_fill", "host_ms_per_batch", "closure_iters",
          "semiring_mfu"} <= set(res["metrics"])
  # no device trace on the CPU: the device's readers stay silent
  assert "idle_pct" not in res["metrics"]
  assert 0.0 < res["metrics"]["batch_fill"]["value"] <= 100.0
  assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
  assert res["device"]["window_s"] > 0


def _cli(args, cwd):
  env = dict(os.environ)
  env.pop("PYTHONPATH", None)
  return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                        env=env, capture_output=True, text=True, timeout=120)


def test_the_command_refuses_to_run_without_the_card(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a card is present: the command would run")
  root = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  out = _cli(["--workload", "apsp-bulk", "--seed", "1", "--seconds", "1",
              "--trace", "0"], root)
  assert out.returncode != 0 and out.stdout == ""
  assert "cuda" in out.stderr


def test_the_command_refuses_to_run_with_only_the_benchmarks_files(tmp_path):
  import shutil
  root = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
  shutil.copytree(os.path.join(root, "bench"), tmp_path / "bench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  out = _cli(["--workload", "apsp-bulk", "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path)
  assert out.returncode != 0 and out.stdout == ""


def test_loaded_jax_is_found_by_whole_top_level_names(monkeypatch):
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))
  import importlib
  run = importlib.import_module("bench.run")
  monkeypatch.setitem(sys.modules, "repro_torch_like", object())
  assert "repro" not in run.loaded_forbidden() or "repro" in {
      m.split(".")[0] for m in sys.modules}
  monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
  assert "jaxlib" in run.loaded_forbidden()
  assert json.dumps(run.FORBIDDEN)
