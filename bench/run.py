"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload apsp-bulk --seed 7 --seconds 30 --trace 0

Runs from the root of a checkout on a machine with the cards the cell asks
for, drives ``repro_torch.serve_mmo.MMOEngine`` (``src/``) on them, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit
(also the last lines on standard error).  Exits non-zero, printing no
result, without the cards, or if JAX or the JAX package got loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches stay inside the checkout, at fixed paths, so only
# a cell's first run there builds (K1 and K2 build into build/kernels/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" /
                                         "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ.pop("REPRO_TORCH_COST_TABLE", None)  # no cost table is loaded
for p in (ROOT, ROOT / "src"):
  if str(p) not in sys.path:
    sys.path.insert(0, str(p))

from bench.lib import cell as cell_mod  # noqa: E402
from bench.lib import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
  """Top-level module names of JAX or the JAX package in this process,
  compared whole (``repro_torch`` is not ``repro``)."""
  tops = {name.split(".", 1)[0] for name in list(sys.modules)}
  return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
  t_start = cell_mod.process_start_s()
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  if not (ROOT / "src" / "repro_torch").is_dir():
    print("src/repro_torch is not in this checkout: nothing to run",
          file=sys.stderr)
    return 2
  cell = spec.load_cell(args.workload)
  import torch
  if not torch.cuda.is_available():
    print("torch.cuda.is_available() is false: the benchmark runs on the "
          "card only", file=sys.stderr)
    return 2
  if torch.cuda.device_count() < cell.chips:
    print(f"{args.workload} needs {cell.chips} cards, "
          f"{torch.cuda.device_count()} present", file=sys.stderr)
    return 2
  result = cell_mod.run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), t_start=t_start)
  found = loaded_forbidden()
  if found:
    print(f"modules of JAX or the JAX package were loaded: {found}",
          file=sys.stderr)
    return 3
  for name, c in result["checks"].items():
    print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
