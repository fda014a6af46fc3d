"""Roofline constants of the card the port runs on (``hw``), the ring model
of one collective and the reference's HLO collective parser
(``collectives``), the three-term roofline of a dry-run cell
(``analysis``) and the dispatch-time counter of FLOPs, bytes and live
memory that takes the place of the reference's HLO walk (``flops``).

Counterpart of ``repro/roofline``.
"""
from repro_torch.roofline import analysis, collectives, flops, hw

__all__ = ["analysis", "collectives", "flops", "hw"]
