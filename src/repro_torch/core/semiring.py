"""Semiring-like structure registry — the heart of SIMD² (PyTorch port).

The paper (§2.1) identifies the algebraic structure ``D = C ⊕ (A ⊗ B)``
where ⊕ is an addition-like reduction and ⊗ a multiplication-like element
op contracted over the inner (k) dimension.  Nine (⊕, ⊗) pairs are exposed
as SIMD² instructions (paper Table 2); this module registers them as torch
ops with their identities, dtype rules and contraction pads.  Counterpart of
``repro/core/semiring.py``; ``oplus_allreduce`` comes with the distributed
slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
    return torch.full(shape, self.oplus_identity, dtype=dtype, device=device)

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


def oplus_reduce(sr, x: Tensor, dim: int) -> Tensor:
  """⊕-reduction along one dimension of a single tensor."""
  sr = get(sr)
  if sr.boolean:
    return torch.any(x, dim=dim)
  if sr.oplus is torch.add:
    return torch.sum(x, dim=dim)
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


def contraction_pads(sr) -> tuple:
  """(pad_a, pad_b) for K-axis padding with ⊗(pad_a, pad_b) == ⊕-identity."""
  return _CONTRACTION_PADS[get(sr).name]
