"""repro_torch.analysis — dependency-free static analysis for the port.

Three rule families, the reference's (``repro/analysis``) retargeted to the
PyTorch/CUDA port:

  * ``semiring`` — literal pad/identity tables, and the CUDA kernels' ring
    table (``kernels/csrc/semiring_ring.cuh``), cross-checked against the
    live ``core.semiring`` registry, plus numeric law checking over
    adversarial values in f32 and int32 (repro_torch.analysis.laws);
  * ``locks``    — a declared GUARDED_BY table for the port's mutable shared
    state enforced by an AST lock-domination pass
    (repro_torch.analysis.lock_rules);
  * ``capture``  — no host synchronisation on the kernel launch paths a CUDA
    graph would capture, and executable-cache key coverage
    (repro_torch.analysis.capture_rules).

Run it::

    python -m repro_torch.analysis                # human output, exit 1 on new
    python -m repro_torch.analysis --json         # machine output (CI artifact)
    python -m repro_torch.analysis --rules locks  # one family (or rule id)

Findings carry a line-independent fingerprint; known-accepted ones live in
``baseline.json`` next to this package, and one-off exceptions are
suppressed in source with ``# repro: ignore[rule-id]``.
"""
from repro_torch.analysis.core import (FAMILIES, Context, Finding, Module,
                                       Report, all_rules, format_human,
                                       format_json, load_baseline,
                                       load_context, rule, run,
                                       save_baseline, select_rules)

# importing the rule modules registers their rules with the registry
from repro_torch.analysis import capture_rules as _capture_rules  # noqa: F401
from repro_torch.analysis import laws as _laws                    # noqa: F401
from repro_torch.analysis import lock_rules as _lock_rules        # noqa: F401
from repro_torch.analysis import semiring_rules as _semiring_rules  # noqa: F401

__all__ = [
    "FAMILIES", "Context", "Finding", "Module", "Report", "all_rules",
    "format_human", "format_json", "load_baseline", "load_context", "rule",
    "run", "save_baseline", "select_rules",
]
