"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
  """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

  The port never falls back to the CPU on its own: a caller that wants the
  plain PyTorch arms passes ``device="cpu"``.
  """
  dev = torch.device(device)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          f"device {str(device)!r} requested but torch.cuda.is_available() "
          f"is false; pass device='cpu' to run the plain PyTorch versions")
    if dev.index is None:  # pin the card, so every thread uses the same one
      dev = torch.device("cuda", torch.cuda.current_device())
  return dev
