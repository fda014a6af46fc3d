"""Sparse SIMD² (paper §6.5): 2:4 structured sparsity + CSR crossover study.

Two artifacts:
  * ``prune_24`` / ``mmo_sparse24`` — structured 2:4 sparsity along K: keep
    the 2 largest-|x| of every 4 A-entries, contract only those (exactly the
    sparse-Tensor-Core execution model).  Plain tensor code (gather + ⊗ +
    ⊕-reduce), as in the reference: it runs wherever its tensors lie.
  * ``csr_spmm`` — a semiring CSR×dense row-gather SpMM on the host, in
    float64, and ``csr_spmm_np``, the plain mma one in numpy: the stand-ins
    for cuSparse in the Fig-14 density-crossover study.

Counterpart of ``repro/core/sparse.py``.  The reference's CSR arm runs its
⊗/⊕ through jnp, in f32 unless JAX's 64-bit mode is on; the port's runs
them in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod

Tensor = torch.Tensor


def prune_24(a: Tensor):
  """Keep the 2 largest-magnitude entries of each group of 4 along K (ties
  to the lower index, as the reference's stable argsort).

  Returns (compact (M, K/2) values, idx (M, K/2) int32 column indices)."""
  m, k = a.shape
  if k % 4 != 0:
    raise ValueError(f"2:4 pruning needs K divisible by 4, got {k}")
  g = a.reshape(m, k // 4, 4)
  order = torch.argsort(-torch.abs(g), dim=-1, stable=True)[..., :2]
  order = torch.sort(order, dim=-1).values                    # keep k-order
  vals = torch.gather(g, -1, order)                           # (M, K/4, 2)
  base = (torch.arange(k // 4, device=a.device) * 4)[None, :, None]
  idx = (order + base).reshape(m, k // 2)
  return vals.reshape(m, k // 2), idx.to(torch.int32)


def densify_24(vals: Tensor, idx: Tensor, k: int) -> Tensor:
  m = vals.shape[0]
  out = torch.zeros((m, k), dtype=vals.dtype, device=vals.device)
  rows = torch.arange(m, device=vals.device)[:, None]
  out[rows, idx.long()] = vals
  return out


def mmo_sparse24(vals: Tensor, idx: Tensor, b: Tensor, c=None, *,
                 op: str = "mma") -> Tensor:
  """Contract the 2:4-compacted A against dense B: per output row i the
  needed B rows are gathered by idx[i] — half the ⊗ work of the dense op."""
  sr = sr_mod.get(op)
  acc = sr.acc_dtype(vals.dtype)
  b_rows = b[idx.long()]                          # (M, K/2, N) gather
  prod = sr.otimes(vals[..., None].to(acc), b_rows.to(acc))
  out = sr_mod.oplus_reduce(sr, prod, dim=1)
  if c is not None:
    out = sr.oplus(out, c.to(out.dtype))
  return out


# --- semiring-aware CSR (the "cuSparse arm" of Fig 14) -----------------------

# Per-ring "absent" entry value: a stored matrix drops entries equal to this,
# and the contraction seeds its accumulator so dropped entries contribute
# nothing.  Soundness requires absent to be a ⊗-annihilator mapping to the
# ⊕-identity — ⊗(absent, x) must equal the ⊕-identity for every x in the
# ring's domain — which ``validate_csr_seed`` re-verifies numerically.  For
# the mul/max rings the annihilator property holds on the engine's
# positive-weight domain (0 is the no-edge sentinel there, matching
# core/closure.py).  addnorm has NO absent value — (absent−b)² cannot be 0
# for all b — so sparse storage is undefined for it, exactly like closure
# padding.
_ABSENT = {
    "mma": 0.0,
    "minplus": float(np.inf),
    "maxplus": float(-np.inf),
    "minmul": float(np.inf),
    "maxmul": 0.0,
    "minmax": float(np.inf),
    "maxmin": 0.0,
    "orand": 0.0,       # False
    "addnorm": None,    # no ⊗-annihilator: sparsity undefined
}


def csr_absent_value(op: str) -> float:
  """The entry value ``to_csr`` drops for ``op`` (its ⊗-annihilator).

  Raises ValueError for rings with no annihilator (addnorm)."""
  sr = sr_mod.get(op)
  absent = _ABSENT[sr.name]
  if absent is None:
    raise ValueError(
        f"op {sr.name!r} has no ⊗-annihilator, so absent entries cannot "
        f"drop out of the contraction — CSR storage is undefined for it")
  return absent


def _scalar(sr: sr_mod.Semiring, v) -> Tensor:
  return torch.tensor(bool(v) if sr.boolean else float(v),
                      dtype=torch.bool if sr.boolean else torch.float64)


def validate_csr_seed(op: str, *, samples=None) -> None:
  """Check numerically that dropping ``op``'s absent value is sound: for
  domain operands x, y the absorption law ⊕(⊗(absent, x), y) == y must hold
  (and never produce NaN) — an absent entry's product contributes nothing.

  Checked on the ring's *operating domain* (positive weights for the
  mul/maxmin rings, where 0 is the no-edge sentinel), not over all floats:
  maxmul's absent 0 absorbs under max only because stored products are
  positive.  Raises ValueError when the table entry is unsound."""
  sr = sr_mod.get(op)
  absent = csr_absent_value(op)  # raises for addnorm
  if samples is None:
    samples = ([False, True] if sr.boolean else
               [0.25, 1.0, 2.0] if sr.name in ("minmul", "maxmul", "maxmin")
               else [-3.0, -1.0, 0.0, 0.5, 2.0])
  for x in samples:
    prod = sr.otimes(_scalar(sr, absent), _scalar(sr, x))
    if not sr.boolean and bool(torch.isnan(prod)):
      raise ValueError(
          f"CSR absent value {absent!r} for op {op!r} poisons the "
          f"contraction: ⊗({absent!r}, {x!r}) is NaN")
    for y in samples:
      got = float(sr.oplus(prod, _scalar(sr, y)))
      want = float(_scalar(sr, y))
      if np.isnan(got) or got != want:
        raise ValueError(
            f"CSR absent value {absent!r} for op {op!r} is not absorbed: "
            f"⊕(⊗({absent!r}, {x!r}), {y!r}) == {got!r}, want {y!r} — "
            f"dropped entries would change results")


def to_csr(a: np.ndarray, *, op: str = "mma"):
  """CSR-compress ``a``, dropping entries equal to the ring's absent value
  (validated against the semiring registry; op="mma" drops zeros)."""
  validate_csr_seed(op)
  absent = csr_absent_value(op)
  m, _ = a.shape
  indptr = [0]
  indices, data = [], []
  for i in range(m):
    nz = np.nonzero(a[i] != absent)[0]
    indices.append(nz)
    data.append(a[i, nz])
    indptr.append(indptr[-1] + len(nz))
  return (np.asarray(indptr), np.concatenate(indices) if indices else
          np.zeros(0, np.int64), np.concatenate(data) if data else
          np.zeros(0, a.dtype))


def csr_spmm(indptr, indices, data, b: np.ndarray, *,
             op: str = "mma") -> np.ndarray:
  """Semiring CSR×dense SpMM on the host, result identical to the dense
  contraction (float64; bool for orand).

  Rows are seeded with the *absorbed product* ⊗(absent, absent) — what a
  dropped entry contributes in the dense op (constant over the ring's
  domain; +inf for minplus, "no path") — so rows with no stored entries
  match the dense result, and absorption (``validate_csr_seed``) guarantees
  the seed vanishes the moment a stored product lands."""
  validate_csr_seed(op)
  sr = sr_mod.get(op)
  absent = csr_absent_value(op)
  m = len(indptr) - 1
  work = torch.bool if sr.boolean else torch.float64
  bt = torch.from_numpy(np.asarray(b).astype(bool if sr.boolean
                                             else np.float64))
  dt = torch.from_numpy(np.asarray(data).astype(bool if sr.boolean
                                                else np.float64))
  it = torch.from_numpy(np.asarray(indices, np.int64))
  empty = sr.otimes(_scalar(sr, absent), _scalar(sr, absent))
  out = torch.full((m, bt.shape[1]), empty.item(), dtype=work)
  for i in range(m):
    lo, hi = int(indptr[i]), int(indptr[i + 1])
    if hi > lo:
      prod = sr.otimes(dt[lo:hi, None], bt[it[lo:hi]])
      out[i] = sr_mod.oplus_reduce(sr, prod, dim=0)
  return out.numpy()


def csr_spmm_np(indptr, indices, data, b: np.ndarray) -> np.ndarray:
  """The historical mma fast path (plain @-based row gather) used by the
  Fig-14 density-crossover benchmark."""
  m = len(indptr) - 1
  out = np.zeros((m, b.shape[1]), np.float64)
  for i in range(m):
    lo, hi = indptr[i], indptr[i + 1]
    if hi > lo:
      out[i] = data[lo:hi] @ b[indices[lo:hi]]
  return out
