"""Nothing under bench/ imports JAX or the JAX package, and the reference
imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported_tops(path: Path) -> set:
  tree = ast.parse(path.read_text(), filename=str(path))
  tops = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      tops.update(a.name.split(".", 1)[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      tops.add(node.module.split(".", 1)[0])
  return tops


def test_no_module_under_bench_imports_jax_or_the_jax_package():
  files = sorted(BENCH.rglob("*.py"))
  assert len(files) > 10
  for path in files:
    bad = _imported_tops(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(BENCH)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
  for path in sorted((BENCH / "reference").rglob("*.py")):
    tops = _imported_tops(path)
    assert "repro_torch" not in tops, path.name
    assert not tops & FORBIDDEN, path.name


def test_the_walk_compares_whole_top_level_names(tmp_path):
  f = tmp_path / "m.py"
  f.write_text("import repro_torch.serve_mmo\nfrom repro_torch import api\n")
  assert _imported_tops(f) & FORBIDDEN == set()
  f.write_text("import repro.core\n")
  assert _imported_tops(f) & FORBIDDEN == {"repro"}
