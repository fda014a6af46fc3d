"""Semiring closure solvers — the paper's host-side algorithms (§4, Fig 7).

Counterpart of ``repro/core/closure.py``:

  * All-pairs Bellman-Ford:  D ← D ⊕ (D ⊗ A), up to |V| iterations.
  * Leyzorek / repeated squaring:  C ← C ⊕ (C ⊗ C), lg|V| iterations.
  * Optional convergence check each iteration for early exit (Fig 7's
    ``check_convergence``).
  * Floyd-Warshall as the classic O(V³) one-pass reference.

The reference runs each fixpoint as one ``lax.while_loop`` that never syncs
with the host.  Here the per-iteration ('dispatch') loop is Python over
device tensors and syncs once per iteration, to read whether any request is
still changing (``bool(active.any())``); the fused arm
(``fixpoint_backend="megakernel"``, kernel K2) syncs once per chunk of
``megakernel_g`` iterations.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.core.mmo import mmo as _mmo

Tensor = torch.Tensor


def _default_mmo(a, b, c, op, backend, k_valid=None):
  return _mmo(a, b, c, op=op, backend=backend, k_valid=k_valid)


def _same(new: Tensor, old: Tensor) -> Tensor:
  """Elementwise 'unchanged': inf == inf of the same sign counts as
  unchanged, and so does NaN staying NaN — a NaN in place is a fixed point
  like any other value (result validation rejects NaN outputs separately);
  without it a NaN-bearing request would spin its batch to max_iters."""
  return ((new == old)
          | (torch.isinf(new) & torch.isinf(old)
             & (torch.sign(new) == torch.sign(old)))
          | (torch.isnan(new) & torch.isnan(old)))


def _changed(new: Tensor, old: Tensor) -> Tensor:
  if new.dtype == torch.bool:
    return torch.any(new != old)
  return ~torch.all(_same(new, old))


def _iters_leyzorek(n: int, max_iters: Optional[int]) -> int:
  return max_iters if max_iters is not None else max(
      1, math.ceil(math.log2(max(n, 2))))


def _fixpoint(adj: Tensor, step, iters: int, check_convergence: bool):
  if not check_convergence:
    c = adj
    for _ in range(iters):
      c = step(c)
    return c, torch.tensor(iters, dtype=torch.int32)
  c, i, changed = adj, 0, True
  while changed and i < iters:
    new = step(c)
    changed = bool(_changed(new, c))
    c, i = new, i + 1
  return c, torch.tensor(i, dtype=torch.int32)


def leyzorek_closure(adj: Tensor,
                     *,
                     op: str,
                     max_iters: Optional[int] = None,
                     check_convergence: bool = True,
                     backend: str = "pallas",
                     mmo_fn: Optional[Callable] = None):
  """Repeated squaring C ← C ⊕ (C ⊗ C); lg|V| worst-case iterations.

  Returns (closure, iterations_run).
  """
  f = mmo_fn or _default_mmo
  return _fixpoint(adj, lambda c: f(c, c, c, op, backend),
                   _iters_leyzorek(adj.shape[-1], max_iters),
                   check_convergence)


def bellman_ford_closure(adj: Tensor,
                         *,
                         op: str,
                         max_iters: Optional[int] = None,
                         check_convergence: bool = True,
                         backend: str = "pallas",
                         mmo_fn: Optional[Callable] = None):
  """All-pairs Bellman-Ford D ← D ⊕ (D ⊗ A); |V| worst-case iterations."""
  f = mmo_fn or _default_mmo
  iters = max_iters if max_iters is not None else adj.shape[-1]
  return _fixpoint(adj, lambda d: f(d, adj, d, op, backend), iters,
                   check_convergence)


# ---------------------------------------------------------------------------
# Batched closures — the serving engine's entry points.  One call closes a
# whole (R, n, n) stack of same-bucket problems; a per-request convergence
# mask freezes finished problems (their values and iteration counters stop)
# while stragglers keep iterating.
#
# With ``valid_n`` (one true problem size per request), each step's mmo also
# gets a per-request live-K count: rows/columns beyond a request's true n are
# isolated-vertex padding whose contraction terms are ⊕-identity no-ops, so
# the backends skip them.  Converged requests are handed k_valid=0 — their
# step output is discarded by the freeze — so finished problems stop paying
# contraction work.
# ---------------------------------------------------------------------------


def _batched_changed(new: Tensor, old: Tensor) -> Tensor:
  """(R, n, n) × (R, n, n) → (R,) per-request changed flags."""
  r = new.shape[0]
  if new.dtype == torch.bool:
    return (new != old).reshape(r, -1).any(dim=1)
  return ~_same(new, old).reshape(r, -1).all(dim=1)


def _fixpoint_state(adj: Tensor, valid_n=None) -> tuple:
  """(iterate, active, iterations, valid_n) before a batched fixpoint's
  first step."""
  r = adj.shape[0]
  dev = adj.device
  if valid_n is not None:
    valid_n = torch.as_tensor(valid_n, dtype=torch.int32, device=dev)
  active = torch.ones((r,), dtype=torch.bool, device=dev)
  iters = torch.zeros((r,), dtype=torch.int32, device=dev)
  return adj, active, iters, valid_n


def _fixpoint_step(state: tuple, step_fn) -> tuple:
  """One per-request-masked step ``c ← step_fn(c, k_valid)`` of a batched
  fixpoint, with no host sync: converged requests are handed k_valid=0 and
  frozen, and their counters stop."""
  c, active, iters, valid_n = state
  kv = None if valid_n is None else torch.where(
      active, valid_n, torch.zeros_like(valid_n))
  new = step_fn(c, kv)
  new = torch.where(active[:, None, None], new, c)
  changed = _batched_changed(new, c)
  return new, active & changed, iters + active.to(torch.int32), valid_n


def _batched_fixpoint(adj: Tensor, step_fn, max_iters: int,
                      valid_n=None):
  """Iterate ``c ← step_fn(c, k_valid)`` per-request-masked to convergence."""
  state = _fixpoint_state(adj, valid_n)
  i = 0
  while i < max_iters and bool(state[1].any()):
    state = _fixpoint_step(state, step_fn)
    i += 1
  return state[0], state[2]


def _dispatch_fixpoint(adj: Tensor, *, op: str, algorithm: str,
                       max_iters: Optional[int], backend: str,
                       mmo_fn: Optional[Callable]) -> tuple:
  """(first iterate, step function, iteration budget) of the batched
  dispatch arm of ``algorithm`` ('leyzorek' or 'bellman_ford')."""
  f = mmo_fn or _default_mmo
  if algorithm == "leyzorek":
    iters = _iters_leyzorek(adj.shape[-1], max_iters)
    return (_iterate(adj, op),
            lambda c, kv: f(c, c, c, op, backend, kv), iters)
  if algorithm != "bellman_ford":
    raise ValueError(f"unknown closure algorithm {algorithm!r}")
  iters = max_iters if max_iters is not None else adj.shape[-1]
  a = _iterate(adj, op)
  return a, (lambda d, kv: f(d, a, d, op, backend, kv)), iters


def _fused_arm(adj: Tensor, fixpoint_backend: str, backend: str) -> bool:
  """Validate the batched solvers' arm choice; True for the fused arm
  (``fixpoint_backend="megakernel"``, or the cost-table spelling
  ``backend="megakernel"``)."""
  if adj.ndim < 3:
    raise ValueError(f"batched closure needs (R, n, n) input, got "
                     f"{tuple(adj.shape)}")
  if fixpoint_backend == "megakernel" or backend == "megakernel":
    return True
  if fixpoint_backend != "dispatch":
    raise ValueError(f"unknown fixpoint_backend {fixpoint_backend!r}; "
                     f"one of ('dispatch', 'megakernel')")
  return False


def _iterate(adj: Tensor, op: str) -> Tensor:
  """The dispatch arm's first iterate: mma iterates in f32 whatever its
  input (as the fused arm, ``chunk_geometry``, and the kernel's output do),
  the other rings in the input's dtype."""
  if sr_mod.get(op).name == "mma" and adj.dtype != torch.float32:
    return adj.to(torch.float32)
  return adj


def _megakernel_fixpoint(adj, *, op, algorithm, max_iters, valid_n,
                         megakernel_g):
  """The fused arm's dispatch target (imported here, on use, so that
  kernels/ and core/ import each other only at call time)."""
  from repro_torch.kernels.closure_megakernel import megakernel_fixpoint
  return megakernel_fixpoint(adj, op=op, algorithm=algorithm,
                             max_iters=max_iters, valid_n=valid_n,
                             g=megakernel_g)


def batched_leyzorek_closure(adj: Tensor,
                             *,
                             op: str,
                             max_iters: Optional[int] = None,
                             backend: str = "pallas",
                             mmo_fn: Optional[Callable] = None,
                             valid_n=None,
                             fixpoint_backend: str = "dispatch",
                             megakernel_g: int = 8):
  """Repeated squaring over a (R, n, n) request stack.

  ``valid_n`` (R,) carries each request's true problem size for ragged
  masked-K work skipping.  Returns (closure (R, n, n), per-request iteration
  counts (R,) int32).

  ``fixpoint_backend="megakernel"`` (or ``backend="megakernel"``) runs the
  whole fixpoint through the fused kernel K2 in chunks of ``megakernel_g``
  iterations (kernels/closure_megakernel.py): the same outputs and
  iteration counts, bit for bit, with one host sync per chunk.
  """
  if _fused_arm(adj, fixpoint_backend, backend):
    return _megakernel_fixpoint(
        adj, op=op, algorithm="leyzorek",
        max_iters=_iters_leyzorek(adj.shape[-1], max_iters),
        valid_n=valid_n, megakernel_g=megakernel_g)
  c0, step, iters = _dispatch_fixpoint(adj, op=op, algorithm="leyzorek",
                                       max_iters=max_iters, backend=backend,
                                       mmo_fn=mmo_fn)
  return _batched_fixpoint(c0, step, iters, valid_n=valid_n)


def batched_bellman_ford_closure(adj: Tensor,
                                 *,
                                 op: str,
                                 max_iters: Optional[int] = None,
                                 backend: str = "pallas",
                                 mmo_fn: Optional[Callable] = None,
                                 valid_n=None,
                                 fixpoint_backend: str = "dispatch",
                                 megakernel_g: int = 8):
  """All-pairs Bellman-Ford D ← D ⊕ (D ⊗ A) over a (R, n, n) request stack
  (see ``batched_leyzorek_closure``)."""
  if _fused_arm(adj, fixpoint_backend, backend):
    return _megakernel_fixpoint(
        adj, op=op, algorithm="bellman_ford",
        max_iters=max_iters if max_iters is not None else adj.shape[-1],
        valid_n=valid_n, megakernel_g=megakernel_g)
  c0, step, iters = _dispatch_fixpoint(adj, op=op, algorithm="bellman_ford",
                                       max_iters=max_iters, backend=backend,
                                       mmo_fn=mmo_fn)
  return _batched_fixpoint(c0, step, iters, valid_n=valid_n)


def floyd_warshall(adj: Tensor, *, op: str) -> Tensor:
  """Classic k-pivot closure (rank-1 ⊕-updates); O(V) sequential steps of
  O(V²) work — an oracle and the paper's CUDA-FW baseline family."""
  sr = sr_mod.get(op)
  d = adj
  for k in range(adj.shape[-1]):
    row = d[..., k:k + 1, :]  # (1, n)
    col = d[..., :, k:k + 1]  # (n, 1)
    d = sr.oplus(d, sr.otimes(col, row).to(d.dtype))
  return d


# Per-ring adjacency conventions: ``self`` is the ⊗-identity-ish self
# distance on the diagonal, ``missing`` the no-edge sentinel.  ``missing`` is
# deliberately the *graph* sentinel (0 for maxmul/maxmin capacities), not the
# ⊕-identity: identity-padding a mul-ring adjacency would put −inf next to 0
# weights and manufacture NaNs in ⊗.
_SELF_VALUES = {
    "minplus": 0.0, "maxplus": 0.0,
    "minmul": 1.0, "maxmul": 1.0,
    "minmax": float("-inf"), "maxmin": float("inf"),
    "orand": 1.0, "mma": 0.0, "addnorm": 0.0,
}

_MISSING_VALUES = {
    "minplus": float("inf"), "maxplus": float("-inf"),
    "minmul": float("inf"), "maxmul": 0.0,
    "minmax": float("inf"), "maxmin": 0.0,
    "orand": 0.0, "mma": 0.0, "addnorm": 0.0,
}


def closure_pad_values(op) -> tuple:
  """(missing, self) values for growing an adjacency matrix of ring ``op``.

  Padding a prepared adjacency to (nb, nb) with ``missing`` everywhere and
  ``self`` on the new diagonal adds isolated vertices, so the closure of the
  padded matrix restricted to the original block equals the original
  closure — the invariant the serving layer's shape bucketing relies on.

  Rings without a ⊗-identity (addnorm) have no such embedding:
  ``(x − missing)² == x²`` lets pad vertices feed values back into the real
  block after one squaring, so closure requests on them are refused.
  """
  sr = sr_mod.get(op)
  if sr.otimes_identity is None:
    raise ValueError(
        f"op {sr.name!r} has no ⊗-identity, so adjacency padding cannot "
        f"embed isolated vertices — closure is undefined for this ring")
  return _MISSING_VALUES[sr.name], _SELF_VALUES[sr.name]


def pad_adjacency(adj, nb: int, *, op: str) -> np.ndarray:
  """Embed a prepared (n, n) adjacency into (nb, nb) as isolated vertices.

  Host-side numpy utility (the micro-batcher calls it per request).
  """
  sr = sr_mod.get(op)
  adj = np.asarray(adj)
  n = adj.shape[-1]
  if nb == n:
    return adj
  if nb < n:
    raise ValueError(f"cannot pad {n}→{nb}")
  missing, self_value = closure_pad_values(op)
  diag = np.arange(n, nb)
  if sr.boolean:
    out = np.zeros(adj.shape[:-2] + (nb, nb), dtype=bool)
    out[..., :n, :n] = adj
    out[..., diag, diag] = True
    return out
  out = np.full(adj.shape[:-2] + (nb, nb), missing, dtype=adj.dtype)
  out[..., :n, :n] = adj
  out[..., diag, diag] = np.asarray(self_value, adj.dtype)
  return out


def prepare_adjacency(weights: Tensor, *, op: str,
                      self_value: Optional[float] = None) -> Tensor:
  """Fill the diagonal with the ring's self value (0 for plus-based paths, 1
  for mul-based reliabilities, True for orand, ∓inf for minmax/maxmin)."""
  sr = sr_mod.get(op)
  n = weights.shape[-1]
  if self_value is None:
    self_value = _SELF_VALUES[sr.name]
  eye = torch.eye(n, dtype=torch.bool, device=weights.device)
  if sr.boolean:
    return torch.where(eye, True, weights.to(torch.bool))
  return torch.where(eye, torch.tensor(self_value, dtype=weights.dtype,
                                       device=weights.device), weights)
