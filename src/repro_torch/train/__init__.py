"""Serving steps of the LM (training comes with a later slice)."""
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
