"""``mmo`` — the SIMD² matrix-matrix-operation API (paper §3.2/§4), PyTorch.

``D = C ⊕ (A ⊗ B)`` with A: (..., M, K), B: (..., K, N), C/D: (..., M, N).
Counterpart of ``repro/core/mmo.py``; the backend names map 1:1 onto the
reference's so engine and executable-cache keys translate:

  'vector'  — blocked broadcast-⊗ + ⊕-reduce in plain PyTorch (the
              reference's 'vector' arm).  Correct on any device; its
              O(M·bk·N) intermediate per K block makes it slow on the card.
  'xla'     — the ``torch.matmul`` rewrites where an exact one exists
              (mma → matmul, addnorm → ‖a‖²+‖b‖²−2ab expansion on
              translated coordinates, orand → count > 0), otherwise
              'vector'.
              The reference's 'xla' arm left the same matmuls to XLA.
  'pallas'  — the hand-written SIMD² unit kernel (``kernels/ops.py`` →
              ``kernels/csrc/semiring_mmo.cu``), the reference's Pallas arm.
              On CPU tensors it runs the kernel's plain PyTorch version.
  'auto'    — consult the measured cost table (repro_torch.tuning) for
              the cheapest (backend, block config) of the call's shape
              bucket; without a table, 'xla'.

'pallas' and 'vector' compute addnorm's Σ(a−b)² directly.  The reference's
'xla' expansion cancels catastrophically when coordinates are large; the
port's first translates both operands by one of B's points, which leaves
every distance unchanged and the expansion's terms small.

Ragged contraction: ``k_valid`` (an int scalar, or one per leading request)
declares how many leading K lanes are live.  The caller guarantees K lanes
at or beyond ``k_valid`` are algebraic no-ops, so backends may skip them:
the kernel skips dead K steps per request, the vector path contracts only up
to ``max(k_valid)`` (one host sync), and the matmul rewrites ignore it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import semiring as sr_mod

Tensor = torch.Tensor

_DEFAULT_BLOCK_K = 512
# Aim for at least this many dynamic K-blocks when a k_valid hint is present,
# so skipping dead blocks has useful granularity.
_DYN_K_BLOCKS = 8
BACKENDS = ("xla", "vector", "pallas")


def _check_shapes(a, b, c):
  if a.ndim < 2 or b.ndim < 2:
    raise ValueError(f"mmo operands must be >=2D, got {tuple(a.shape)} "
                     f"{tuple(b.shape)}")
  if a.shape[-1] != b.shape[-2]:
    raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                     f"{tuple(b.shape)}")
  m, n = a.shape[-2], b.shape[-1]
  if c is not None and tuple(c.shape[-2:]) != (m, n):
    raise ValueError(f"C shape {tuple(c.shape)} != ({m},{n})")
  for t in (b, c):
    if t is not None and t.device != a.device:
      raise ValueError(f"operands on different devices: {a.device}, "
                       f"{t.device}")


# ---------------------------------------------------------------------------
# vector backend: blocked broadcast/reduce.
# ---------------------------------------------------------------------------


def _blk(a_blk: Tensor, b_blk: Tensor, sr: sr_mod.Semiring, acc_dtype):
  # (..., m, bk, 1) ⊗ (..., 1, bk, n) → ⊕ over bk
  prod = sr.otimes(a_blk[..., :, :, None].to(acc_dtype),
                   b_blk[..., None, :, :].to(acc_dtype))
  return sr_mod.oplus_reduce(sr, prod, dim=-2)


def _contract_vector(a: Tensor, b: Tensor, sr: sr_mod.Semiring,
                     block_k: int) -> Tensor:
  """⊕_k ⊗(a[..,m,k], b[..,k,n]) by scanning K blocks."""
  k = a.shape[-1]
  acc_dtype = sr.acc_dtype(a.dtype)
  block_k = max(1, min(block_k, k))
  out = _blk(a[..., :block_k], b[..., :block_k, :], sr, acc_dtype)
  for k0 in range(block_k, k, block_k):
    out = sr.oplus(out, _blk(a[..., k0:k0 + block_k],
                             b[..., k0:k0 + block_k, :], sr, acc_dtype))
  return out


def _dyn_block_k(k: int, block_k: int) -> int:
  """K-block size for the ragged path: shrink toward ~_DYN_K_BLOCKS blocks so
  the dynamic trip count has granularity to skip dead work."""
  bk = min(block_k, k)
  while bk > 8 and k / bk < _DYN_K_BLOCKS:
    bk = (bk + 1) // 2
  return max(bk, 1)


def _contract_vector_dynk(a: Tensor, b: Tensor, sr: sr_mod.Semiring,
                          block_k: int, k_valid: Tensor) -> Tensor:
  """Ragged vector contraction: only ``ceil(max(k_valid)/bk)`` K-blocks run.

  Batch-max semantics — requests with a smaller ``k_valid`` still see lanes
  up to the batch max, which the k_valid contract guarantees are ⊕-identity
  no-ops, so results match the full contraction exactly.  Reading the max
  is one host sync.
  """
  *batch, m, k = a.shape
  acc_dtype = sr.acc_dtype(a.dtype)
  bk = _dyn_block_k(k, block_k)
  kp = ((k + bk - 1) // bk) * bk
  if kp != k:  # pad the K tail so every dynamic block is full-width
    pa, pb = ((False, False) if sr.boolean else
              sr_mod.contraction_pads(sr, a.dtype))
    a = torch.cat([a, a.new_full(tuple(batch) + (m, kp - k), pa)], dim=-1)
    b = torch.cat([b, b.new_full(tuple(b.shape[:-2]) + (kp - k, b.shape[-1]),
                                 pb)], dim=-2)
  nblocks = kp // bk
  live = min(max((int(k_valid.max()) + bk - 1) // bk, 1), nblocks)
  out = _blk(a[..., :bk], b[..., :bk, :], sr, acc_dtype)
  for i in range(1, live):
    out = sr.oplus(out, _blk(a[..., i * bk:(i + 1) * bk],
                             b[..., i * bk:(i + 1) * bk, :], sr, acc_dtype))
  return out


# ---------------------------------------------------------------------------
# matmul rewrites (the reference's MXU-reuse rewrites, DESIGN.md §2).
# ---------------------------------------------------------------------------


def _contract_matmul(a: Tensor, b: Tensor, sr: sr_mod.Semiring) -> Tensor:
  del sr
  return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _contract_addnorm(a: Tensor, b: Tensor, sr: sr_mod.Semiring) -> Tensor:
  """Σ_k (a−b)² = Σa² − 2Σab + Σb² on coordinates translated by B's first
  column.

  A shared translation leaves every (a−b) unchanged, and it keeps the three
  terms near the points' spread instead of their magnitude, so they no
  longer cancel catastrophically at large coordinates.  B's first column is
  a real point in every padded serving layout (pads are appended), unlike
  a mean over its columns, which padded zero columns would drag away.  Its
  non-finite coordinates translate by 0 instead, so an inf or NaN there
  stays in its own column of the result.
  """
  del sr
  a, b = a.to(torch.float32), b.to(torch.float32)
  if b.shape[-1] > 0:
    origin = b[..., :, :1]  # (..., K, 1): one point of B, per feature
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    a, b = a - origin.transpose(-1, -2), b - origin
  ab = torch.matmul(a, b)
  a2 = torch.sum(a * a, dim=-1, keepdim=True)
  b2 = torch.sum(b * b, dim=-2, keepdim=True)
  return a2 - 2.0 * ab + b2


def _contract_orand(a: Tensor, b: Tensor, sr: sr_mod.Semiring) -> Tensor:
  """or-and over {0,1} == (#k: a∧b) > 0 — a thresholded matmul (f32 counts
  are exact up to 2²⁴ terms)."""
  del sr
  cnt = torch.matmul((a != 0).to(torch.float32), (b != 0).to(torch.float32))
  return cnt > 0.5


_REWRITES = {
    "matmul": _contract_matmul,
    "addnorm": _contract_addnorm,
    "orand": _contract_orand,
}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _resolve_auto(op: str, a: Tensor, b: Tensor) -> tuple:
  """backend='auto' → (backend, block cfg) from the active cost table.  A
  'pallas' row's tile (a table the reference measured carries one) does
  not apply: the kernel chooses its own."""
  from repro_torch.tuning import dispatch as _dispatch
  d = _dispatch.resolve(op, a.shape[-2], a.shape[-1], b.shape[-1], a.dtype)
  return d.backend, (() if d.backend == "pallas" else d.cfg)


def mmo(a: Tensor,
        b: Tensor,
        c: Optional[Tensor] = None,
        *,
        op="mma",
        backend: str = "pallas",
        block_k: int = _DEFAULT_BLOCK_K,
        block: Optional[tuple] = None,
        k_valid=None) -> Tensor:
  """D = C ⊕ (A ⊗ B).  See the module docstring for backend semantics.

  ``block`` is a block config: ``(block_k,)`` for the vector path, ``()`` for
  the defaults.  The kernel chooses its own tile by its shape rule
  (``kernels.semiring_mmo.tile_shape``), so the 'pallas' arm takes no block
  config.  ``backend='auto'`` fills the block from the cost table when the
  caller leaves it unset.
  """
  if backend == "megakernel":
    raise ValueError(
        "backend 'megakernel' fuses whole closure fixpoints, not single "
        "contractions — select it via batched_leyzorek_closure / "
        "batched_bellman_ford_closure(fixpoint_backend='megakernel')")
  if backend == "auto":
    backend, cfg = _resolve_auto(op, a, b)
    if block is None:
      block = cfg
  if backend not in BACKENDS:
    raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
  sr = sr_mod.get(op)
  _check_shapes(a, b, c)
  if sr.boolean:
    a, b = a.to(torch.bool), b.to(torch.bool)

  if block:
    if backend == "pallas":
      raise NotImplementedError(
          f"the 'pallas' arm takes no block config: the kernel chooses its "
          f"tile by its shape rule (kernels.semiring_mmo.tile_shape), got "
          f"{block!r}")
    if len(block) != 1:
      raise ValueError(f"block config must be (block_k,), got {block!r}")
    block_k = int(block[0])

  if k_valid is not None:
    k_valid = torch.as_tensor(k_valid, dtype=torch.int32, device=a.device)
  if backend == "pallas":
    from repro_torch.kernels import ops as kops
    return kops.semiring_mmo(a, b, c, op=sr.name, k_valid=k_valid)
  if backend == "xla" and sr.mxu_rewrite is not None:
    # full padded K through the matmul — the k_valid hint is not worth a
    # branch here
    out = _REWRITES[sr.mxu_rewrite](a, b, sr)
  elif k_valid is None:
    out = _contract_vector(a, b, sr, block_k)
  else:
    out = _contract_vector_dynk(a, b, sr, block_k, k_valid)
  if c is not None:
    out = sr.oplus(out, c.to(out.dtype))
  return out


def mmo_batched(a: Tensor,
                b: Tensor,
                c: Optional[Tensor] = None,
                *,
                op="mma",
                backend: str = "pallas",
                block_k: int = _DEFAULT_BLOCK_K,
                block: Optional[tuple] = None,
                k_valid=None) -> Tensor:
  """D[r] = C[r] ⊕ (A[r] ⊗ B[r]) over a leading request axis.

  The serving engine's raw-mmo entry point.  Every backend takes the
  leading axis natively ('pallas' as the kernel's grid axis); this wrapper
  pins the contract and validates that all operands agree on the request
  count.  ``k_valid`` optionally carries one live-K count per request.
  """
  if a.ndim < 3 or b.ndim < 3:
    raise ValueError(f"mmo_batched needs (R, M, K)/(R, K, N), got "
                     f"{tuple(a.shape)} {tuple(b.shape)}")
  if c is not None and c.ndim < 3:
    raise ValueError(f"mmo_batched needs (R, M, N) for c, got "
                     f"{tuple(c.shape)}")
  if a.shape[0] != b.shape[0] or (c is not None and c.shape[0] != a.shape[0]):
    shapes = f"a={tuple(a.shape)} b={tuple(b.shape)}" + (
        "" if c is None else f" c={tuple(c.shape)}")
    raise ValueError(f"request-axis mismatch: {shapes}")
  return mmo(a, b, c, op=op, backend=backend, block_k=block_k, block=block,
             k_valid=k_valid)


def mmo_reference(a, b, c=None, *, op="mma"):
  """Unblocked O(MKN)-memory oracle (tests only)."""
  from repro_torch.kernels.ref import semiring_mmo_ref
  return semiring_mmo_ref(a, b, c, op=op)
