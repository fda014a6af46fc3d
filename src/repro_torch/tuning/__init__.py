"""Measured cost-table dispatch: autotuned backend and block selection.

Counterpart of ``repro.tuning``:

  cost_table — versioned JSON table of measured (and roofline-priored)
               seconds per (op, shape bucket, dtype, backend, block config),
               with the port's H100 prior, and mesh rows per distributed
               schedule (``SCHEDULE_ARMS``, ``sharded_prior_seconds``);
  autotune   — times the live device (CUDA events on a card) to fill the
               table, ``tune_mesh`` the schedules on a device mesh;
               ``--dry-prior`` fills it from the prior only;
  dispatch   — the brain of ``backend="auto"``: per call signature, the
               cheapest (backend, block config) the table knows, and with a
               mesh shape whether a schedule beats the local arm.
"""
from repro_torch.tuning.cost_table import (CLOSURE_BACKENDS, CostEntry,
                                           CostTable, DEFAULT_CONFIGS,
                                           Decision, SCHEDULE_ARMS,
                                           SCHEMA_VERSION, prior_seconds,
                                           sharded_prior_seconds, signature)
from repro_torch.tuning.autotune import tune, tune_for_requests, tune_mesh
from repro_torch.tuning.dispatch import (clear_cost_table,
                                         contraction_seconds, get_cost_table,
                                         resolve, set_cost_table,
                                         use_cost_table)

__all__ = [
    "CLOSURE_BACKENDS",
    "CostEntry", "CostTable", "Decision", "DEFAULT_CONFIGS", "SCHEDULE_ARMS",
    "SCHEMA_VERSION", "prior_seconds", "sharded_prior_seconds", "signature",
    "tune", "tune_for_requests", "tune_mesh", "clear_cost_table",
    "contraction_seconds", "get_cost_table",
    "resolve", "set_cost_table", "use_cost_table",
]
