"""Measured cost-table dispatch: autotuned backend and block selection.

Counterpart of ``repro.tuning`` on one device:

  cost_table — versioned JSON table of measured (and roofline-priored)
               seconds per (op, shape bucket, dtype, backend, block config),
               with the port's H100 prior;
  autotune   — times the live device (CUDA events on a card) to fill the
               table; ``--dry-prior`` fills it from the prior only;
  dispatch   — the brain of ``backend="auto"``: per call signature, the
               cheapest (backend, block config) the table knows.

The distributed half (``SCHEDULE_ARMS``, ``sharded_prior_seconds``,
``tune_mesh``) waits for ROADMAP Queue 1 item 11.
"""
from repro_torch.tuning.cost_table import (CLOSURE_BACKENDS, CostEntry,
                                           CostTable, DEFAULT_CONFIGS,
                                           Decision, SCHEMA_VERSION,
                                           prior_seconds, signature)
from repro_torch.tuning.autotune import tune, tune_for_requests
from repro_torch.tuning.dispatch import (clear_cost_table,
                                         contraction_seconds, get_cost_table,
                                         resolve, set_cost_table,
                                         use_cost_table)

__all__ = [
    "CLOSURE_BACKENDS",
    "CostEntry", "CostTable", "Decision", "DEFAULT_CONFIGS",
    "SCHEMA_VERSION", "prior_seconds", "signature",
    "tune", "tune_for_requests", "clear_cost_table",
    "contraction_seconds", "get_cost_table",
    "resolve", "set_cost_table", "use_cost_table",
]
