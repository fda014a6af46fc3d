"""Unblocked PyTorch oracles for the port's kernels.

Counterpart of ``repro/kernels/ref.py``: each kernel (and its plain blocked
version) is held against these over shape/dtype sweeps.  ``attention_ref``
comes with the LM slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import semiring as sr_mod

Tensor = torch.Tensor


def semiring_mmo_ref(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                     op: str = "mma") -> Tensor:
  """Unblocked D = C ⊕ (A ⊗ B) oracle (O(M·K·N) memory)."""
  sr = sr_mod.get(op)
  acc = sr.acc_dtype(a.dtype)
  if sr.boolean:
    a, b = a.to(torch.bool), b.to(torch.bool)
    prod = sr.otimes(a[..., :, :, None], b[..., None, :, :])
  else:
    prod = sr.otimes(a[..., :, :, None].to(acc), b[..., None, :, :].to(acc))
  out = sr_mod.oplus_reduce(sr, prod, dim=-2)
  if c is not None:
    out = sr.oplus(out, c.to(out.dtype))
  return out


def addnorm_ref(a: Tensor, b: Tensor, c: Optional[Tensor] = None) -> Tensor:
  """Pairwise squared-L2: D[i,j] = Σ_k (a[i,k] − b[k,j])² (+ C)."""
  return semiring_mmo_ref(a, b, c, op="addnorm")
