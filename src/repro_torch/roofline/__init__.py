"""Roofline constants of the card the port runs on (``hw``) and the ring
model of one collective (``collectives``).

Counterpart of ``repro/roofline``.  The dry-run analysis (``analysis``,
``hlo_walk`` and ``collectives.collective_bytes``, which read XLA's HLO)
comes with ROADMAP Queue 1 item 13.
"""
from repro_torch.roofline import collectives, hw

__all__ = ["collectives", "hw"]
