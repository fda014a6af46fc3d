"""Ring-model traffic of one collective: the formulas the sharded cost
prior charges (``tuning/cost_table.sharded_prior_seconds``).

Counterpart of ``repro/roofline/collectives.py``'s ``ring_traffic_bytes``.
Per device, for a collective over ``n`` shards moving ``bytes``:

    all-reduce          2·(n−1)/n · bytes     (reduce-scatter + all-gather)
    all-gather          (n−1)/n · out_bytes
    reduce-scatter      (n−1)/n · in_bytes
    all-to-all          (n−1)/n · bytes
    collective-permute  bytes                 (one hop)

The reference's ``collective_bytes`` reads XLA's optimized HLO; its
counterpart comes with the dry run, ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_traffic_bytes(kind: str, nbytes: float, group_size: int) -> float:
  """Per-device ring-model traffic for one collective moving ``nbytes``."""
  n = max(group_size, 1)
  if kind == "all-reduce":
    return 2.0 * (n - 1) / n * nbytes
  if kind in ("all-gather", "reduce-scatter", "all-to-all"):
    return (n - 1) / n * nbytes
  if kind == "collective-permute":
    return float(nbytes)
  raise ValueError(f"unknown collective kind {kind!r}; one of {_COLL_KINDS}")
