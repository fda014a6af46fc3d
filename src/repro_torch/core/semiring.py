"""Semiring-like structure registry — the heart of SIMD² (PyTorch port).

The paper (§2.1) identifies the algebraic structure ``D = C ⊕ (A ⊗ B)``
where ⊕ is an addition-like reduction and ⊗ a multiplication-like element
op contracted over the inner (k) dimension.  Nine (⊕, ⊗) pairs are exposed
as SIMD² instructions (paper Table 2); this module registers them as torch
ops with their identities, dtype rules and contraction pads.  Counterpart of
``repro/core/semiring.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _sq_diff(a: Tensor, b: Tensor) -> Tensor:
  d = a - b
  return d * d


@dataclasses.dataclass(frozen=True)
class Semiring:
  """One SIMD² (⊕, ⊗) pair.

  Attributes:
    name:            instruction mnemonic (paper Table 2, e.g. ``minplus``).
    oplus:           reduction operator (addition-like, associative+commutative).
    otimes:          element operator applied before the k-contraction.
    oplus_identity:  identity element of ``oplus`` (used to pad / init tiles).
    otimes_identity: identity element of ``otimes``, or None when the op has
                     none (addnorm's squared difference).
    algorithm:       representative algorithm from paper Table 1 (docs only).
    boolean:         operates on {0,1}/bool lattice (or-and).
    mxu_rewrite:     name of an exact matmul-reuse rewrite ('matmul',
                     'addnorm', 'orand') or None for the min/max family.
    accumulate_f32:  16-bit in, 32-bit out for the (+)-reductions; min/max
                     rings keep the input dtype.
  """

  name: str
  oplus: Callable[[Tensor, Tensor], Tensor]
  otimes: Callable[[Tensor, Tensor], Tensor]
  oplus_identity: float
  otimes_identity: Optional[float]
  algorithm: str
  boolean: bool = False
  mxu_rewrite: Optional[str] = None
  accumulate_f32: bool = True

  def identity_like(self, shape, dtype, device=None) -> Tensor:
    if self.boolean:
      return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.full(shape, saturate(self.oplus_identity, dtype),
                      dtype=dtype, device=device)

  def acc_dtype(self, in_dtype: torch.dtype) -> torch.dtype:
    if self.boolean:
      return torch.bool
    if self.accumulate_f32 and in_dtype.is_floating_point:
      return torch.float32
    return in_dtype


_REGISTRY: dict[str, Semiring] = {}


def _register(sr: Semiring) -> Semiring:
  _REGISTRY[sr.name] = sr
  return sr


MMA = _register(Semiring(
    name="mma", oplus=torch.add, otimes=torch.mul, oplus_identity=0.0,
    otimes_identity=1.0, algorithm="GEMM / matrix inverse",
    mxu_rewrite="matmul"))

MINPLUS = _register(Semiring(
    name="minplus", oplus=torch.minimum, otimes=torch.add,
    oplus_identity=float("inf"), otimes_identity=0.0,
    algorithm="all-pairs shortest paths", accumulate_f32=False))

MAXPLUS = _register(Semiring(
    name="maxplus", oplus=torch.maximum, otimes=torch.add,
    oplus_identity=float("-inf"), otimes_identity=0.0,
    algorithm="maximum cost (critical path)", accumulate_f32=False))

MINMUL = _register(Semiring(
    name="minmul", oplus=torch.minimum, otimes=torch.mul,
    oplus_identity=float("inf"), otimes_identity=1.0,
    algorithm="minimum reliability paths", accumulate_f32=False))

MAXMUL = _register(Semiring(
    name="maxmul", oplus=torch.maximum, otimes=torch.mul,
    oplus_identity=float("-inf"), otimes_identity=1.0,
    algorithm="maximum reliability paths", accumulate_f32=False))

MINMAX = _register(Semiring(
    name="minmax", oplus=torch.minimum, otimes=torch.maximum,
    oplus_identity=float("inf"), otimes_identity=float("-inf"),
    algorithm="minimum spanning tree", accumulate_f32=False))

MAXMIN = _register(Semiring(
    name="maxmin", oplus=torch.maximum, otimes=torch.minimum,
    oplus_identity=float("-inf"), otimes_identity=float("inf"),
    algorithm="maximum capacity paths", accumulate_f32=False))

ORAND = _register(Semiring(
    name="orand", oplus=torch.logical_or, otimes=torch.logical_and,
    oplus_identity=0.0, otimes_identity=1.0,
    algorithm="transitive & reflexive closure", boolean=True,
    mxu_rewrite="orand", accumulate_f32=False))

ADDNORM = _register(Semiring(
    name="addnorm", oplus=torch.add, otimes=_sq_diff, oplus_identity=0.0,
    otimes_identity=None, algorithm="L2 distance (KNN / k-means)",
    mxu_rewrite="addnorm"))

ALL_OPS: tuple[str, ...] = tuple(_REGISTRY)


def get(name_or_sr) -> Semiring:
  """Look up a semiring by mnemonic (or pass a Semiring through)."""
  if isinstance(name_or_sr, Semiring):
    return name_or_sr
  try:
    return _REGISTRY[str(name_or_sr)]
  except KeyError:
    raise ValueError(
        f"unknown SIMD² op {name_or_sr!r}; available: {sorted(_REGISTRY)}"
    ) from None


# ---------------------------------------------------------------------------
# ⊕ as a cross-shard collective.  Every SIMD² ⊕ is +, min, max or or, so a
# K-sharded contraction needs only one generalized all-reduce
# (core/distributed.py).
# ---------------------------------------------------------------------------


def oplus_reduce_parts(sr, parts) -> Tensor:
  """The ⊕ of one tensor per shard, on the first part's device: a reduce
  to shard 0.  The parts are reduced in shard order (peer copies of the
  others).  + sums in the parts' dtype, as ``oplus_reduce`` does; or is a
  logical or."""
  sr = get(sr)
  parts = list(parts)
  if not parts:
    raise ValueError("oplus_reduce_parts needs at least one part")
  home = parts[0].device
  total = parts[0]
  for p in parts[1:]:
    p = p.to(home, non_blocking=True)
    if sr.boolean:
      total = torch.logical_or(total, p)
    elif sr.oplus is torch.add:
      total = torch.add(total, p)
    elif sr.oplus in (torch.minimum, torch.maximum):
      total = sr.oplus(total, p)
    else:
      raise NotImplementedError(sr.name)
  return total


def oplus_allreduce(sr, parts) -> list:
  """The ⊕ of one tensor per shard, returned on each shard's own device:
  ``oplus_reduce_parts`` on the first part's device, then copied back to
  every part's device."""
  parts = list(parts)
  if not parts:
    raise ValueError("oplus_allreduce needs at least one part")
  total = oplus_reduce_parts(sr, parts)
  return [total.to(p.device, non_blocking=True) for p in parts]


def oplus_reduce(sr, x: Tensor, dim: int) -> Tensor:
  """⊕-reduction along one dimension of a single tensor."""
  sr = get(sr)
  if sr.boolean:
    return torch.any(x, dim=dim)
  if sr.oplus is torch.add:  # in x's dtype: torch widens integer sums
    return torch.sum(x, dim=dim, dtype=x.dtype)
  if sr.oplus is torch.minimum:
    return torch.amin(x, dim=dim)
  if sr.oplus is torch.maximum:
    return torch.amax(x, dim=dim)
  raise NotImplementedError(sr.name)


# K-padding values.  Padding the contraction dimension of A with ``pa`` and
# of B with ``pb`` is an algebraic no-op because ⊗(pa, pb) == the ⊕-identity
# (and never NaN: maxmul uses (−inf, +inf) so the product is −inf, not the
# −inf·−inf = +inf a naive identity-pad would give).  Shared by the kernel's
# K-tail masking and the serving layer's shape bucketing.
_CONTRACTION_PADS = {
    "mma": (0.0, 0.0),
    "minplus": (float("inf"), float("inf")),
    "maxplus": (float("-inf"), float("-inf")),
    "minmul": (float("inf"), float("inf")),
    "maxmul": (float("-inf"), float("inf")),
    "minmax": (float("inf"), float("inf")),
    "maxmin": (float("-inf"), float("-inf")),
    "orand": (0.0, 0.0),
    "addnorm": (0.0, 0.0),
}


def _integer_info(dtype):
  """iinfo of an integer torch or numpy dtype; None for the others."""
  if dtype is None:
    return None
  if isinstance(dtype, torch.dtype):
    return (None if dtype.is_floating_point or dtype == torch.bool
            else torch.iinfo(dtype))
  dtype = np.dtype(dtype)
  return np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None


def saturate(v: float, dtype=None):
  """``v`` as a value of ``dtype`` (torch or numpy).  An integer dtype has
  no inf: ±inf saturate to its range, as the reference's casts do, so its
  largest value stands for +inf (the min rings' ⊕-identity) and its
  smallest for −inf."""
  info = _integer_info(dtype)
  if info is None:
    return v
  return int(min(max(v, info.min), info.max))


def oplus_identity(sr, dtype=None):
  """The ⊕-identity as a value of ``dtype`` (``saturate``)."""
  return saturate(get(sr).oplus_identity, dtype)


def contraction_pads(sr, dtype=None) -> tuple:
  """(pad_a, pad_b) for K-axis padding with ⊗(pad_a, pad_b) == ⊕-identity.

  For an integer ``dtype`` the min/max rings pad with (⊕-identity,
  ⊗-identity): INT32_MAX + 0 stays INT32_MAX, where INT32_MAX + INT32_MAX
  would wrap (csrc/semiring_ring.cuh, ``SIMD2_IRING``)."""
  sr = get(sr)
  pads = _CONTRACTION_PADS[sr.name]
  if _integer_info(dtype) is None or pads == (0.0, 0.0):
    return pads
  top = oplus_identity(sr, dtype)
  if sr.otimes in (torch.add, torch.mul):
    return top, int(sr.otimes_identity)
  return top, top
