"""The port stands alone: no file under src/repro_torch/, nor chip_smoke.py,
imports JAX or anything of the reference package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
  tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield node.lineno, alias.name
    elif isinstance(node, ast.ImportFrom):
      if node.level:
        raise AssertionError(f"{path}:{node.lineno}: relative import")
      yield node.lineno, node.module or ""
    elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
          and node.func.attr == "import_module" and node.args
          and isinstance(node.args[0], ast.Constant)):
      yield node.lineno, str(node.args[0].value)


def test_the_scan_covers_the_port():
  names = {p.name for p in FILES}
  assert {"semiring.py", "mmo.py", "closure.py", "engine.py",
          "attention.py", "flash_attention.py", "serve.py", "ssm.py",
          "ssd.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
  for lineno, mod in _imported_modules(path):
    top = mod.split(".")[0]
    assert top not in FORBIDDEN, f"{path}:{lineno} imports {mod}"
