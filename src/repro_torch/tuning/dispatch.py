"""The brain of ``backend="auto"``: cost-table-driven backend selection.

Counterpart of ``repro/tuning/dispatch.py`` for one device.
``resolve(op, m, k, n, dtype)`` returns the cheapest (backend, block
config) the active cost table knows for the call's bucket signature, and
the default ('xla') when no table is loaded or the table has nothing for
the point.  Resolution is host-side dict work, cheap enough to run per
``mmo`` call, and deterministic, so the serving engine's per-bucket
memoization and its executable cache agree.

The active table is process-global (``set_cost_table`` /
``use_cost_table``) and can be seeded from the ``REPRO_TORCH_COST_TABLE``
environment variable, which is how a persisted table ships into a serving
job.  The variable is the port's own: a table measured for the reference on
another device never steers the port by accident.  Callers that need
isolation (the engine, tests) pass ``table=`` instead.

With ``mesh_shape``, ``resolve`` also places a bucket on a device mesh:
the distributed schedule arms compete with the local choice, from measured
mesh rows where the table has them and from ``sharded_prior_seconds``
otherwise (model against model: an unmeasured mesh never beats a local
measurement on the prior alone).
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional, Sequence, Union

from repro_torch.tuning.cost_table import (CLOSURE_BACKENDS, SCHEDULE_ARMS,
                                           CostTable, Decision,
                                           prior_seconds,
                                           sharded_prior_seconds)

__all__ = ["ENV_VAR", "DEFAULT_BACKEND", "CLOSURE_BACKENDS",
           "set_cost_table", "clear_cost_table", "get_cost_table",
           "use_cost_table", "contraction_seconds", "resolve"]

ENV_VAR = "REPRO_TORCH_COST_TABLE"
DEFAULT_BACKEND = "xla"

_lock = threading.Lock()
_table: Optional[CostTable] = None
_env_checked = False


def set_cost_table(table: Union[CostTable, str, None]) -> None:
  """Install the process-global cost table (a CostTable or a JSON path).
  ``None`` means *explicitly no table*: the environment lookup stays
  disarmed, so ``use_cost_table(None)`` really scopes to table-less
  dispatch even when ``$REPRO_TORCH_COST_TABLE`` is set.  Use
  ``clear_cost_table`` to re-arm the environment default instead."""
  global _table, _env_checked
  with _lock:
    if isinstance(table, (str, os.PathLike)):
      table = CostTable.load(table)
    _table = table
    _env_checked = True


def clear_cost_table() -> None:
  """Drop the installed table and re-arm the ``$REPRO_TORCH_COST_TABLE``
  lookup (the process-default state)."""
  global _table, _env_checked
  with _lock:
    _table = None
    _env_checked = False


def get_cost_table() -> Optional[CostTable]:
  """Active global table; loads ``$REPRO_TORCH_COST_TABLE`` once if set."""
  global _table, _env_checked
  with _lock:
    if _table is None and not _env_checked:
      _env_checked = True
      path = os.environ.get(ENV_VAR)
      if path:
        _table = CostTable.load(path)
    return _table


@contextlib.contextmanager
def use_cost_table(table: Union[CostTable, str, None]):
  """Scoped ``set_cost_table`` (restores the previous table on exit)."""
  prev = get_cost_table()
  set_cost_table(table)
  try:
    yield get_cost_table()
  finally:
    set_cost_table(prev)


def contraction_seconds(op: str, m: int, k: int, n: int, dtype, *,
                        backend: str = "auto",
                        table: Optional[CostTable] = None) -> tuple:
  """(backend, cfg, seconds): the static per-contraction cost of one bucket
  signature.  Under ``backend="auto"`` the table's cheapest row (measured
  beats prior), for a fixed backend that backend's best row, and the
  analytic prior when the table holds nothing for the point.  Seconds are
  always finite.

  This is where dispatch hands over to the serving engine's estimator
  (serve_mmo/estimator.py): the value is the estimator's cold-start prior,
  which live observations then correct.  Keeping it beside ``resolve`` pins
  that the prediction and the dispatch decision read the same table the
  same way.
  """
  if backend == "auto":
    d = resolve(op, m, k, n, dtype, table=table)
    chosen, cfg, s = d.backend, d.cfg, d.seconds
  else:
    chosen, cfg, s = backend, (), float("inf")
    table = table if table is not None else get_cost_table()
    best = table.best(op, (m, k, n), dtype,
                      backends=(backend,)) if table else None
    if best is not None:
      cfg, s = best.cfg, best.seconds
  if not math.isfinite(s):
    s = prior_seconds(op, (m, k, n), dtype, chosen, cfg)
  return chosen, cfg, s


def resolve(op: str, m: int, k: int, n: int, dtype, *,
            table: Optional[CostTable] = None,
            backends: Optional[Sequence[str]] = None,
            mesh_shape: Optional[Sequence[int]] = None,
            schedules: Optional[Sequence[str]] = None) -> Decision:
  """Dispatch decision for one call signature (raw or bucketed shape): the
  table's cheapest row among ``backends`` (default: the per-contraction
  arms), or ``DEFAULT_BACKEND`` with source 'default'.

  With ``mesh_shape`` (a (rows, cols) mesh shape) the schedule arms of
  ``SCHEDULE_ARMS`` (or only ``schedules``) compete too, and the Decision's
  ``backend`` may be a schedule name with the mesh shape as its ``cfg``.
  A measured mesh row competes with whatever the local arm holds; an
  unmeasured one's prior (on the local choice's backend) with the local
  *prior*.  Measured rows beat priors inside the sharded pool as well.
  """
  table = table if table is not None else get_cost_table()
  local = table.best(op, (m, k, n), dtype, backends=backends) \
      if table is not None else None
  if local is None:
    local = Decision(DEFAULT_BACKEND, (), float("inf"), "default")
  if mesh_shape is None:
    return local

  dims = tuple(int(d) for d in mesh_shape)
  arms = []
  for sched in (schedules if schedules is not None else SCHEDULE_ARMS):
    if sched not in SCHEDULE_ARMS:
      raise ValueError(f"unknown schedule {sched!r}; one of {SCHEDULE_ARMS}")
    entry = table.lookup(op, (m, k, n), dtype, sched, dims) \
        if table is not None else None
    if entry is not None:
      arms.append(Decision(sched, dims, entry.seconds, entry.source))
    else:
      arms.append(Decision(
          sched, dims,
          sharded_prior_seconds(op, (m, k, n), dtype, sched, dims,
                                backend=local.backend), "prior"))
  if not arms:
    return local
  measured = [a for a in arms if a.source == "measured"]
  best_sharded = min(measured or arms, key=lambda a: a.seconds)
  local_s = local.seconds
  if best_sharded.source == "prior" and local.source != "prior":
    local_s = prior_seconds(op, (m, k, n), dtype, local.backend, local.cfg)
  if not math.isfinite(local_s):  # 'default' local: no table at all
    local_s = prior_seconds(op, (m, k, n), dtype, local.backend, local.cfg)
  return best_sharded if best_sharded.seconds < local_s else local
