"""Unblocked PyTorch oracles for the port's kernels.

Counterpart of ``repro/kernels/ref.py``: each kernel (and its plain blocked
version) is held against these over shape/dtype sweeps.
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


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None) -> Tensor:
  """Dense softmax attention oracle.

  q: (B, H, Sq, D); k, v: (B, H, Skv, D) — head-group expansion (GQA) is the
  caller's job.  Causal and sliding-window masks, q rows aligned to the end
  of kv; masked scores are -inf, so a row that sees no key is NaN.
  """
  *_, sq, d = q.shape
  skv = k.shape[-2]
  scale = (d ** -0.5) if scale is None else scale
  logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
  qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
  kpos = torch.arange(skv, device=q.device)[None, :]
  mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
  if causal:
    mask &= kpos <= qpos
  if window is not None:
    mask &= kpos > qpos - window
  logits = torch.where(mask, logits, -torch.inf)
  probs = torch.softmax(logits, dim=-1)
  out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
  return out.to(q.dtype)
