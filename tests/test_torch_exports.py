"""The port's packages export the reference's public names.

For each package, ``__all__`` must equal the reference's, minus the names
whose modules are not ported yet; each of those is listed below with the
ROADMAP Queue 1 item that ports it.  Every exported name must resolve, and
where the reference exports a module the port exports a module too.
"""
import importlib
import types

import pytest

pytest.importorskip("torch")

# name -> ROADMAP Queue 1 item that ports it
UNPORTED = {
    "core": {},
    "apps": {},
    "kernels": {},
    "tuning": {},
    "models": {},
    "train": {},
    "serve_mmo": {},
    "analysis": {},
    "data": {},
}
ROADMAP_ITEMS = {14}


def _reference_all(package: str) -> list:
  """The reference package's __all__, read from its source: importing it
  would pull in JAX (and, for tuning and serve_mmo, much more)."""
  import ast
  from pathlib import Path
  src = (Path(__file__).resolve().parents[1] / "src" / "repro" / package
         / "__init__.py")
  for node in ast.parse(src.read_text(encoding="utf-8")).body:
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
        and getattr(node.targets[0], "id", None) == "__all__"):
      return list(ast.literal_eval(node.value))
  raise AssertionError(f"{src} has no __all__")


@pytest.mark.parametrize("package", sorted(UNPORTED))
def test_all_matches_the_reference_minus_unported(package):
  port = importlib.import_module(f"repro_torch.{package}")
  ref = _reference_all(package)
  unported = UNPORTED[package]
  assert set(unported) <= set(ref), "an unported name the reference lacks"
  assert len(port.__all__) == len(set(port.__all__))
  assert set(port.__all__) == set(ref) - set(unported)


@pytest.mark.parametrize("package", sorted(UNPORTED))
def test_every_exported_name_resolves(package):
  port = importlib.import_module(f"repro_torch.{package}")
  for name in port.__all__:
    assert getattr(port, name) is not None, f"repro_torch.{package}.{name}"


def test_unported_names_cite_open_roadmap_items():
  for names in UNPORTED.values():
    assert set(names.values()) <= ROADMAP_ITEMS


@pytest.mark.parametrize("package,module", [
    ("apps", "graphs"), ("apps", "baselines"), ("models", "zoo"),
    ("train", "checkpoint")])
def test_module_exports_are_modules(package, module):
  port = importlib.import_module(f"repro_torch.{package}")
  assert isinstance(getattr(port, module), types.ModuleType)


def test_every_reference_model_module_has_a_counterpart():
  """Each module of the reference's ``models`` package (the enc-dec, VLM
  and pipeline ones included) has a module of the same name in the
  port's."""
  from pathlib import Path
  src = Path(__file__).resolve().parents[1] / "src"
  ref = {p.stem for p in (src / "repro" / "models").glob("*.py")}
  port = {p.stem for p in (src / "repro_torch" / "models").glob("*.py")}
  assert {"encdec", "vlm", "pipeline"} <= ref
  assert ref <= port
  for name in ref - {"__init__"}:
    assert isinstance(importlib.import_module(f"repro_torch.models.{name}"),
                      types.ModuleType)


def test_public_entry_points_import():
  from repro_torch.core import mmo
  from repro_torch.kernels import semiring_mmo
  from repro_torch.serve_mmo import FifoBucketScheduler, bucket_label
  from repro_torch.train import make_decode_step, make_prefill_step
  assert callable(mmo) and callable(semiring_mmo)
  assert FifoBucketScheduler().policy.__class__.__name__ == "FifoPolicy"
  assert callable(bucket_label)
  assert callable(make_prefill_step) and callable(make_decode_step)


def test_kernel_modules_stay_reachable_by_path():
  """The package's semiring_mmo and flash_attention are the entry points;
  the kernel modules behind them are reached by their dotted paths."""
  sm = importlib.import_module("repro_torch.kernels.semiring_mmo")
  fa = importlib.import_module("repro_torch.kernels.flash_attention")
  assert isinstance(sm, types.ModuleType) and hasattr(sm, "LIBRARY")
  assert isinstance(fa, types.ModuleType) and hasattr(fa, "LIBRARY")
