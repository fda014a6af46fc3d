"""REPRO_SANITIZE=1 — opt-in hardened mode for tests, benchmarks and drivers.

Counterpart of ``repro/analysis/sanitize.py``.  When the environment
variable ``REPRO_SANITIZE`` is a truthy value (``1``/``true``/``yes``/
``on``), entry points that call :func:`maybe_enable_sanitize` get three
safety nets:

  * NaN checks at the kernels — each K1–K4 wrapper raises, naming the
    kernel, when its output holds a NaN that its inputs did not
    (``kernels/nan_check.py``), turning silent poison (a NaN that a later
    ``min`` hides) into a loud failure at the producing kernel, as
    ``jax_debug_nans`` does for the reference;
  * ``torch.autograd.set_detect_anomaly`` for training, which names the
    forward op whose backward produced a NaN;
  * an analyzer pre-flight — ``repro_torch.analysis`` runs over
    ``src/repro_torch`` before any workload, so a lock-discipline or
    pad-table regression aborts the run before it can produce misleading
    numbers.

It is opt-in (default off) because each check reads the output back (a
host sync per launch) and anomaly mode slows autograd; the tier-1 suite
must not change behaviour under default settings.
"""
from __future__ import annotations

import os

_TRUTHY = ("1", "true", "yes", "on")


def sanitize_requested(environ=None) -> bool:
  env = os.environ if environ is None else environ
  return str(env.get("REPRO_SANITIZE", "")).strip().lower() in _TRUTHY


def maybe_enable_sanitize(*, preflight: bool = True) -> bool:
  """Enable sanitize mode if requested; returns whether it is active.

  Raises RuntimeError when the analyzer pre-flight finds new findings —
  a dirty tree must not run workloads in sanitize mode.
  """
  if not sanitize_requested():
    return False
  import torch
  from repro_torch.kernels import nan_check
  nan_check.ENABLED = True
  torch.autograd.set_detect_anomaly(True)
  if preflight:
    from repro_torch import analysis
    from repro_torch.analysis.__main__ import DEFAULT_BASELINE, DEFAULT_ROOT
    report = analysis.run(DEFAULT_ROOT,
                          baseline=analysis.load_baseline(DEFAULT_BASELINE))
    if not report.ok:
      raise RuntimeError(
          "REPRO_SANITIZE pre-flight failed — repro_torch.analysis reports "
          f"{len(report.findings)} new finding(s):\n"
          + "\n".join(str(f) for f in report.findings))
  return True
