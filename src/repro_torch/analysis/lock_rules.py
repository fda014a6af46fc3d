"""Lock-discipline rule: declared GUARDED_BY table + an AST domination pass.

Counterpart of ``repro/analysis/lock_rules.py``: the pass and its
conventions are the reference's, the table is the port's own.
``GUARDED_BY`` below *declares* which mutable attributes of each locked
class of the port are protected by which locks.  It is declared, not inferred, on
purpose: inference from observed usage would bless today's bugs as the
spec (an attribute touched unlocked in two places would "infer" as
unguarded), while a declaration is reviewed once and then machine-enforced
forever — the same reason Clang's thread-safety analysis uses GUARDED_BY
annotations rather than guessing.

The pass proves every ``self.<attr>`` read/write of a guarded attribute is
*lexically dominated* by ``with self.<lock>:`` for one of the class's
declared locks, with two escapes:

  * methods whose name ends in ``_locked`` are caller-holds-lock helpers
    (the analyzer enforces that the convention is the ONLY way to defer
    locking);
  * ``__init__`` / ``__del__`` run before/after the object is shared.

Conditions constructed over the same lock count as the lock itself: the
engine's ``_work`` / ``_idle`` are ``threading.Condition(self._lock)``
aliases, so ``with self._work:`` acquires the engine lock.

Nested functions and lambdas do NOT inherit the enclosing ``with`` —
a closure created under the lock may run on another thread after the lock
is released (that is exactly how the executable-cache build lambda is
used), so they are analyzed under their own name's convention only.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.core import Context, Finding, rule

__all__ = ["GUARDED_BY", "LockSpec", "check_class"]


@dataclasses.dataclass(frozen=True)
class LockSpec:
  locks: tuple      # attribute names whose ``with self.<lock>`` protects
  attrs: tuple      # guarded attribute names


# (module suffix, class name) → spec, read from the port's code: every
# mutable attribute that the serving loop's worker thread (or a watchdog
# worker, or a metrics/HTTP reader) and a caller both touch.  ``scheduler``
# and ``admission`` are whole *objects* guarded by the engine lock (their
# classes are documented as not independently thread-safe), so every touch
# of the reference is checked, not just their internals.
GUARDED_BY = {
    ("serve_mmo/engine.py", "MMOEngine"): LockSpec(
        locks=("_lock", "_work", "_idle"),
        attrs=("_decisions", "_schedules", "_static_cost",
               "_fallback_arms_memo", "_records", "_batches", "_rejected",
               "_expired", "_next_id", "_pending", "_inflight", "_running",
               "_stopped", "scheduler", "admission", "_arenas",
               "_arenas_ticked", "_arena_cold", "_arena_failures",
               "_abandoned", "_thread")),
    ("serve_mmo/arena.py", "RequestArena"): LockSpec(
        locks=("_lock",),
        # device state handles (_c/_adj/_kv/_act/_it) are guarded too: admit
        # and tick swap them wholesale, and an unlocked read could pair a
        # pre-tick iterate with post-tick flags
        attrs=("_slots", "_free", "_admit_s", "_admitted", "_evicted",
               "_ticks", "_c", "_adj", "_kv", "_act", "_it")),
    ("serve_mmo/cache.py", "ExecutableCache"): LockSpec(
        locks=("_lock",), attrs=("_entries", "_misses")),
    ("serve_mmo/metrics.py", "ServeMetrics"): LockSpec(
        locks=("_lock",),
        attrs=("_counters", "_rejected_by_reason", "_batch_failures_by_kind",
               "_buckets")),
    ("serve_mmo/estimator.py", "ServiceEstimator"): LockSpec(
        locks=("_lock",), attrs=("_cells", "_iters")),
    ("serve_mmo/resilience.py", "ResilienceManager"): LockSpec(
        locks=("_lock",), attrs=("_breakers",)),
    ("serve_mmo/observability.py", "FlightRecorder"): LockSpec(
        locks=("_lock",), attrs=("_events", "_recorded")),
    # the locked classes the reference's table has no counterpart of
    ("serve_mmo/faults.py", "FaultInjector"): LockSpec(
        locks=("_lock",), attrs=("_rules", "_rng", "_fired_by_point")),
    ("kernels/nvcc.py", "KernelLibrary"): LockSpec(
        locks=("_lock",), attrs=("_lib", "_build_log")),
    ("data/pipeline.py", "Prefetcher"): LockSpec(
        locks=("_lock",), attrs=("_ready",)),
}

_EXEMPT_METHODS = ("__init__", "__del__")


def _is_self_attr(node, names) -> bool:
  return (isinstance(node, ast.Attribute)
          and isinstance(node.value, ast.Name) and node.value.id == "self"
          and node.attr in names)


def check_class(cls_node: ast.ClassDef, spec: LockSpec) -> list:
  """(line, attr, method) for every unprotected guarded-attribute access."""
  violations = []

  def scan(stmts, protected: bool, method: str):
    for stmt in stmts:
      scan_node(stmt, protected, method)

  def scan_node(node, protected: bool, method: str):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      # nested def: the closure may outlive the lock scope — only the
      # _locked convention (or being a fresh __init__) protects its body
      scan(node.body, node.name.endswith("_locked"), method)
      return
    if isinstance(node, ast.Lambda):
      scan_node(node.body, False, method)
      return
    if isinstance(node, ast.With):
      holds = protected or any(
          _is_self_attr(item.context_expr, spec.locks)
          for item in node.items)
      for item in node.items:
        scan_node(item.context_expr, protected, method)
      scan(node.body, holds, method)
      return
    if _is_self_attr(node, spec.attrs):
      if not protected:
        violations.append((node.lineno, node.attr, method))
      return
    for child in ast.iter_child_nodes(node):
      scan_node(child, protected, method)

  for item in cls_node.body:
    if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
      continue
    protected = (item.name in _EXEMPT_METHODS
                 or item.name.endswith("_locked"))
    scan(item.body, protected, item.name)
  return violations


@rule("lock-discipline", family="locks")
def _rule_lock_discipline(ctx: Context) -> list:
  """Guarded attributes may only be touched under their lock."""
  out = []
  for (suffix, cls_name), spec in GUARDED_BY.items():
    mod = ctx.module(suffix)
    if mod is None:
      continue
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.ClassDef) and node.name == cls_name:
        for line, attr, method in check_class(node, spec):
          out.append(Finding(
              rule="lock-discipline", path=mod.relpath, line=line,
              message=f"{cls_name}.{method} touches guarded attribute "
                      f"self.{attr} outside `with self.{spec.locks[0]}` "
                      f"(declared GUARDED_BY {list(spec.locks)}; use the "
                      f"lock or a *_locked helper)"))
  return out
