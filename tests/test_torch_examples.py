"""The port's examples (examples/torch_*.py) on the CPU, one subprocess
each at small sizes: each must exit 0 with every printed check passing
(``[checks] N of N passed``, no check printed ``False``).  On the card,
chip_smoke.py phase 18 runs them at the reference examples' sizes.

Also: ``--device cuda`` with no card raises, in each example, rather than
moving to the CPU."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# example → (the CPU smoke's flags, the checks it prints)
SMOKE = {
    "torch_quickstart": ([], 2),
    "torch_serve_graphs": ([], 7),
    "torch_serve_qos": ([], 3),
    "torch_serve_adaptive": (["--bulk-n", "24"], 2),
    "torch_serve_sharded": ([], 8),
    "torch_apsp_pod_scale": (["--shards", "4", "--n", "128"], 1),
    "torch_serve_lm": ([], 1),
    "torch_train_lm": (["--smoke", "--steps", "20", "--seq", "32",
                        "--lr", "3e-3", "--shards", "8"], 1),
    "torch_vq_retrieval": (["--codes", "1024", "--patches", "128",
                            "--table", "5000"], 2),
}
CHECKS = re.compile(r"^\[checks\] (\d+) of (\d+) passed$", re.M)


def test_every_example_has_a_smoke():
  found = {p.stem for p in (ROOT / "examples").glob("torch_*.py")}
  assert found == set(SMOKE)
  reference = {p.stem for p in (ROOT / "examples").glob("*.py")
               if not p.stem.startswith("torch_")}
  assert {"torch_" + name for name in reference} == found


@pytest.mark.parametrize("name", list(SMOKE))
def test_example_runs_on_the_cpu(name, tmp_path):
  # one intra-op thread: the tier-1 run's workers share the host's cores
  flags, n_checks = SMOKE[name]
  if name == "torch_train_lm":
    flags = flags + ["--ckpt-dir", str(tmp_path / "ckpt")]
  r = subprocess.run(
      [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--device",
       "cpu"] + flags, capture_output=True, text=True, timeout=300,
      cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(SRC),
                             OMP_NUM_THREADS="1"))
  assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
  got = CHECKS.findall(r.stdout)
  assert got == [(str(n_checks), str(n_checks))], r.stdout[-2000:]
  assert not re.search(r"(:|match) False$", r.stdout, re.M), r.stdout


def _load(name):
  spec = importlib.util.spec_from_file_location(
      name, ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", list(SMOKE))
def test_cuda_without_a_card_raises(name, tmp_path):
  argv = ["--device", "cuda"]
  if name == "torch_train_lm":
    argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
  with pytest.raises(RuntimeError, match="cuda"):
    _load(name).main(argv)
