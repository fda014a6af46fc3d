"""SIMD² core: semiring registry, mmo API, closure solvers, distribution
(``repro_torch.core.distributed``: the mesh schedules).

As in the reference, the package name ``mmo`` is the function and shadows
the module of the same name; reach the module with
``from repro_torch.core.mmo import ...`` or
``importlib.import_module("repro_torch.core.mmo")``.
"""
from repro_torch.core.semiring import (ALL_OPS, Semiring, contraction_pads,
                                       get as get_semiring)
from repro_torch.core.mmo import mmo, mmo_batched, mmo_reference
from repro_torch.core.closure import (
    batched_bellman_ford_closure,
    batched_leyzorek_closure,
    bellman_ford_closure,
    closure_pad_values,
    floyd_warshall,
    leyzorek_closure,
    pad_adjacency,
    prepare_adjacency,
)

__all__ = [
    "ALL_OPS",
    "Semiring",
    "get_semiring",
    "contraction_pads",
    "mmo",
    "mmo_batched",
    "mmo_reference",
    "leyzorek_closure",
    "bellman_ford_closure",
    "batched_leyzorek_closure",
    "batched_bellman_ford_closure",
    "floyd_warshall",
    "prepare_adjacency",
    "pad_adjacency",
    "closure_pad_values",
]
