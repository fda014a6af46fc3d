"""Roofline constants of the card the port runs on (``hw``).

Counterpart of ``repro/roofline``.  Only the hardware constants are ported
so far; the dry-run analysis (``analysis``, ``collectives``, ``hlo_walk``)
comes with ROADMAP Queue 1 item 13.
"""
from repro_torch.roofline import hw

__all__ = ["hw"]
