"""The train driver on a mesh of one position (``--device cpu`` with no
``--shards``, or ``--shards 1``) runs the one-device step, as the
reference's driver compiles ``make_train_step`` on its 1 × 1 mesh: it ends
at the loss of ``make_train_step(cfg, oc)`` driven by hand on the same seed
and ``SyntheticLM`` batches (rtol 1e-6, f32), builds no ``ShardedState``,
and its checkpoint resumes on ``--shards 8``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import sharded  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROWS, SEQ, LR = 4, 32, 1e-3
# the smoke sizes gain nothing from more threads, and the tier-1 run's
# workers share the host's cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _flags(arch, steps):
  return ["--arch", arch, "--smoke", "--steps", str(steps), "--batch",
          str(ROWS), "--seq", str(SEQ), "--lr", str(LR), "--log-every",
          str(steps)]


def _run_train(args):
  return subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]
      + args, capture_output=True, text=True, timeout=600,
      env=dict(os.environ, PYTHONPATH=SRC, **ONE_THREAD))


def _loss_of(stdout):
  line = [ln for ln in stdout.splitlines() if "loss=" in ln][-1]
  return float(line.split("loss=")[1].split()[0])


def _by_hand(arch, steps):
  """The last loss of ``steps`` one-device steps on the driver's seed,
  schedule and batches."""
  cfg = configs.get_config(arch, smoke=True)
  oc = AdamWConfig(lr=LR, warmup_steps=max(2, steps // 20),
                   total_steps=steps)
  model = zoo.init(cfg, torch.Generator(device="cpu").manual_seed(0),
                   torch.device("cpu"))
  data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                global_batch=ROWS, seed=0))
  state = (model, init_opt_state(zoo.param_tree(model)))
  step = tsteps.make_train_step(cfg, oc)
  for t in range(steps):
    state, m = step(state, data.batch_at(t))
  return float(m["loss"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_the_driver_runs_the_one_device_step_on_one_position(arch):
  """No ``--shards`` on the CPU: one position, the one-device step, the
  hand-driven step's loss after four steps."""
  r = _run_train(_flags(arch, 4))
  assert r.returncode == 0, r.stderr
  assert "mesh data=1 x model=1 on cpu, one-device step" in r.stdout
  np.testing.assert_allclose(_loss_of(r.stdout), _by_hand(arch, 4),
                             rtol=1e-6)


@pytest.mark.parametrize("shards", [[], ["--shards", "1"]],
                         ids=["no_shards", "shards_1"])
def test_one_position_builds_no_sharded_state(shards, monkeypatch, capsys,
                                              tmp_path):
  """In the driver's own process: no ``shard_state`` call, a step made
  with no mesh, and a checkpoint in the reference's {'params', 'opt'}
  tree."""
  def refuse(*args, **kwargs):
    raise AssertionError("a one-position run built a ShardedState")
  made = []

  def spy(*args, **kwargs):
    made.append(kwargs.get("mesh"))
    return tsteps.make_train_step(*args, **kwargs)
  monkeypatch.setattr(sharded, "shard_state", refuse)
  monkeypatch.setattr("repro_torch.train.make_train_step", spy)
  assert train_mod.main(_flags("tinyllama-1.1b", 2) + shards + [
      "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
      "2"]) == 0
  assert made == [None]
  assert "one-device step" in capsys.readouterr().out
  restored, step = ckpt.restore(str(tmp_path))
  assert step == 2 and sorted(restored) == ["opt", "params"]
  assert int(restored["opt"]["step"]) == 2


def test_a_one_position_checkpoint_resumes_on_a_mesh(tmp_path, capsys):
  """Killed at step 4 of 8 with no ``--shards``, resumed on ``--shards 8``
  (a (4, 2) mesh of CPU shards, the tensor-parallel step): the run ends
  at the uninterrupted one-device run's loss within rtol 1e-3 (steps 5-8
  run four lines of one row, not one line of four: the sums go in other
  orders, as in the reverse crossing of tests/test_torch_train_mesh.py)."""
  common = _flags("tinyllama-1.1b", 8) + ["--ckpt-every", "4",
                                          "--ckpt-dir", str(tmp_path)]
  r = _run_train(common + ["--fail-at", "4"])
  assert r.returncode == 42, r.stderr
  assert "one-device step" in r.stdout
  assert ckpt.latest_step(str(tmp_path)) == 4
  assert train_mod.main(common + ["--device", "cpu", "--shards", "8"]) == 0
  out = capsys.readouterr().out
  assert "resumed from step 4" in out
  assert "mesh data=4 x model=2 on cpu, tensor-parallel step" in out
  np.testing.assert_allclose(_loss_of(out), _by_hand("tinyllama-1.1b", 8),
                             rtol=1e-3)
  assert ckpt.latest_step(str(tmp_path)) == 8
