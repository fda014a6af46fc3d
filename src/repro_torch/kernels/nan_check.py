"""NaN checks at K1–K4's outputs, the port's counterpart of JAX's
``jax_debug_nans``: off unless ``analysis.sanitize`` turns them on
(``REPRO_SANITIZE``).

When on, each kernel wrapper hands its inputs and output to ``checked``,
which raises, naming the kernel, when the output holds a NaN that no input
held.  Reading that back is a host sync, so the check lives here, outside
the launch paths the capture-safety rule keeps sync-free, and costs a flag
test when off.
"""
from __future__ import annotations

import torch

ENABLED = False


def _has_nan(t) -> bool:
  return (isinstance(t, torch.Tensor) and t.is_floating_point()
          and bool(torch.isnan(t).any()))


def checked(kernel: str, inputs, out):
  """``out`` (a tensor, or a tuple whose first item is the kernel's result)
  unchanged; raises FloatingPointError when checks are on and the result
  holds a NaN that none of ``inputs`` held."""
  if not ENABLED:
    return out
  result = out[0] if isinstance(out, tuple) else out
  if _has_nan(result) and not any(_has_nan(t) for t in inputs):
    raise FloatingPointError(
        f"{kernel} produced a NaN from NaN-free inputs (REPRO_SANITIZE): "
        f"output {tuple(result.shape)} {result.dtype} on {result.device}")
  return out
