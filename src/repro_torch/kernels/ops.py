"""Public entry points for the port's kernels: the SIMD² unit (K1), flash
attention (K3) and the SSD intra-chunk term (K4).

Counterparts of ``repro/kernels/ops.py``.  The reference vmaps its 2-D
Pallas MMO kernel over leading batch dims; here the leading dims are
flattened onto the kernel's request axis, which is a grid axis of one
launch (``blockIdx.z``), not a loop.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _fa_kernel, kernel_takes)
from repro_torch.kernels.semiring_mmo import semiring_mmo as _sm_kernel

Tensor = torch.Tensor


def semiring_mmo(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                 op: str = "mma", k_valid=None) -> Tensor:
  """D = C ⊕ (A ⊗ B) over any leading batch dims, one kernel launch.

  ``k_valid`` broadcasts over the batch dims (one live-K count per request),
  so a (R, M, K) batch takes an (R,) vector of per-request K counts — the
  ragged masked-K serving path.  ``c`` is cast to the ring's output dtype
  and folded in the kernel's epilogue.
  """
  sr = sr_mod.get(op)
  batch = tuple(a.shape[:-2])
  if tuple(b.shape[:-2]) != batch:
    raise ValueError(f"batch dims differ: a {tuple(a.shape)}, b "
                     f"{tuple(b.shape)}")
  m, k = a.shape[-2:]
  n = b.shape[-1]
  r = math.prod(batch)
  if sr.boolean:
    a, b = a.to(torch.bool), b.to(torch.bool)
  a3 = a.reshape(r, m, k).contiguous()
  b3 = b.reshape(r, k, n).contiguous()
  c3 = None
  if c is not None:
    c3 = (c.to(sr.acc_dtype(a.dtype)).broadcast_to(batch + (m, n))
          .reshape(r, m, n).contiguous())
  kv = None
  if k_valid is not None:
    kv = (torch.as_tensor(k_valid, dtype=torch.int32, device=a.device)
          .broadcast_to(batch).reshape(r).contiguous())
  out = _sm_kernel(a3, b3, c3, op=sr.name, k_valid=kv)
  return out.reshape(batch + (m, n))


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None, scale: Optional[float] = None,
                    out: Optional[Tensor] = None) -> Tensor:
  """Attention of q (B, H, Sq, D) over k, v (B, Hkv, Skv, D), one K3 launch;
  written into ``out`` when given.

  Query head h reads KV head h // (H / Hkv); q rows sit at the end of the
  kv axis.  Operands keep their strides: the kernel reads strided views as
  long as D is unit-stride (and, in bf16, rows are 16-byte aligned), so
  they are made contiguous only where they are not.
  """
  def fit(t):
    return t if t.device.type == "cpu" or kernel_takes(t) else (
        t.contiguous())
  return _fa_kernel(fit(q), fit(k), fit(v), causal=causal, window=window,
                    scale=scale, out=out)


def ssd_intra_chunk(c: Tensor, b: Tensor, x: Tensor, dt: Tensor, cum: Tensor,
                    *, out: Optional[Tensor] = None) -> Tensor:
  """Intra-chunk SSD output of c, b (BZ, G, Q, N), x (BZ, H, Q, P), dt, cum
  (BZ, H, Q), one K4 launch; f32 (BZ, H, Q, P), written into ``out`` when
  given.

  Head h reads group h // (H / G).  Operands keep their strides: the
  kernel reads strided (z, head, q) views as long as the last axis is
  unit-stride, so they are made contiguous only where it is not.
  """
  def unit_last(t):
    return t if t.stride(-1) == 1 or t.shape[-1] <= 1 else t.contiguous()
  return _ssd.ssd_intra_chunk(unit_last(c), unit_last(b), unit_last(x), dt,
                              cum, out=out)
