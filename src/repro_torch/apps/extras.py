"""The remaining Table-1 applications: matrix inverse (plus-multiply ring)
and k-means (add-norm), completing the paper's application taxonomy.

  * ``newton_inverse`` — Newton–Schulz iteration X ← X(2I − AX): pure mma
    MMOs, quadratic convergence; the paper lists matrix inversion as a
    plus-multiply-ring workload.
  * ``kmeans`` — Lloyd's algorithm where the assignment step is the SIMD²
    ``addnorm`` instruction (pairwise squared-L2 + argmin), the same kernel
    as KNN.

Counterpart of ``repro/apps/extras.py``, with the signatures of the port's
``apps/solvers.py``: inputs are numpy arrays or tensors, ``device`` (default
``"cuda"``) says where they run and ``backend`` forwards to core.mmo
('pallas' = the SIMD²-unit kernel K1).  The reference's ``fori_loop`` is a
plain loop of the same length.  The reference draws k-means' initial
centroids with ``jax.random.choice``; here the caller passes their indices
(``init_idx``), or they are drawn from a ``torch.Generator``, which gives
other indices than JAX's from the same seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.apps.solvers import _as_tensor
from repro_torch.core.mmo import mmo
from repro_torch.device import DEFAULT_DEVICE

Tensor = torch.Tensor


def newton_inverse(a, *, iters: int = 32, backend: str = "pallas",
                   device=DEFAULT_DEVICE):
  """A⁻¹ by Newton–Schulz: X₀ = Aᵀ/(‖A‖₁‖A‖∞); Xₖ₊₁ = Xₖ(2I − A Xₖ).

  Every step is two mma MMOs, and the residual one more: 2·iters + 1 in
  all.  Returns (inverse, residual ‖AX−I‖∞ as a 0-d tensor)."""
  a = _as_tensor(a, device)
  n = a.shape[-1]
  norm1 = torch.max(torch.sum(torch.abs(a), dim=-2))
  norminf = torch.max(torch.sum(torch.abs(a), dim=-1))
  x = (a.T / (norm1 * norminf)).contiguous()
  eye = torch.eye(n, dtype=a.dtype, device=a.device)
  eye2 = 2.0 * eye
  for _ in range(iters):
    ax = mmo(a, x, op="mma", backend=backend)            # A @ X
    x = mmo(x, eye2 - ax, op="mma", backend=backend)     # X(2I − AX)
  resid = torch.max(torch.abs(mmo(a, x, op="mma", backend=backend) - eye))
  return x, resid


def _assign(points: Tensor, cents: Tensor, backend: str) -> tuple:
  d2 = mmo(points, cents.T.contiguous(), op="addnorm", backend=backend)
  return d2, torch.argmin(d2, dim=-1)  # ties to the lower index, as jnp


def kmeans(points, *, k: int, iters: int = 20, seed: int = 0,
           init_idx=None, generator: Optional[torch.Generator] = None,
           backend: str = "pallas", device=DEFAULT_DEVICE):
  """Lloyd's k-means; the assignment step is SIMD².addnorm + argmin.

  points: (N, D).  The initial centroids are ``points[init_idx]``; without
  ``init_idx``, k distinct indices drawn from ``generator`` (a CPU
  ``torch.Generator`` seeded with ``seed`` when none is given).  Returns
  (centroids (k, D), assignments (N,) int32, inertia as a 0-d tensor)."""
  points = _as_tensor(points, device)
  n = points.shape[0]
  if init_idx is None:
    if generator is None:
      generator = torch.Generator().manual_seed(seed)
    init_idx = torch.randperm(n, generator=generator)[:k]
  if not isinstance(init_idx, torch.Tensor):
    init_idx = np.array(init_idx)  # a writable copy
  init_idx = torch.as_tensor(init_idx, dtype=torch.long, device=points.device)
  if init_idx.shape != (k,):
    raise ValueError(f"init_idx must hold k={k} indices, got "
                     f"{tuple(init_idx.shape)}")
  cents = points[init_idx]
  for _ in range(iters):
    _, assign = _assign(points, cents, backend)
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    sums = onehot.T @ points                                  # (k, D)
    counts = torch.sum(onehot, dim=0)[:, None]
    cents = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                        cents)
  d2, assign = _assign(points, cents, backend)
  inertia = torch.sum(torch.min(d2, dim=-1).values)
  return cents, assign.to(torch.int32), inertia
