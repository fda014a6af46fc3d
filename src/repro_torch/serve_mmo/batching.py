"""Pad-and-stack micro-batcher: bucket → one static-shape batch function.

Counterpart of ``repro/serve_mmo/batching.py``.  Three pieces per bucket:

  ``stack_batch``    — host-side: pad every request's operands to the bucket
                       shape and stack along a new leading request axis.
                       Padding is algebra-aware so it is a semantic no-op:
                       K-axis pads use core.semiring.contraction_pads,
                       adjacency pads add isolated vertices
                       (core.closure.closure_pad_values), and KNN batches
                       carry a per-request valid-row count so padded corpus
                       rows are masked to +inf before top-k.  mmo/closure
                       batches carry a per-request live-K / valid-n vector
                       so the kernel may skip dead K work.
  ``make_batch_fn``  — the function the executable cache builds:
                       mmo_batched / batched_*_closure (per-request
                       convergence masks; per-iteration or the fused K2
                       arm) / addnorm + top-k.
  ``split_results``  — slice the padded batch output back to each request's
                       true shape.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.apps.solvers import smallest_k
from repro_torch.core import closure as cl_mod
from repro_torch.core import semiring as sr_mod
from repro_torch.core.mmo import mmo, mmo_batched
from repro_torch.serve_mmo.api import MMOResult, ProblemRequest
from repro_torch.serve_mmo.scheduler import BucketKey


class ShapeDtype(NamedTuple):
  """Shape and numpy dtype of one stacked operand (what prewarm builds
  executables for without materializing data)."""
  shape: tuple
  dtype: np.dtype


def _pad2d(x: np.ndarray, rows: int, cols: int,
           row_val, col_val) -> np.ndarray:
  """Pad a 2-D array to (rows, cols); new rows get row_val, new cols col_val."""
  out = np.full((rows, cols), col_val, dtype=x.dtype)
  out[x.shape[0]:, :] = row_val
  out[:x.shape[0], :x.shape[1]] = x
  return out


def _stack_mmo(key: BucketKey, reqs: Sequence[ProblemRequest]):
  mb, kb, nb = key.shape
  dtype = reqs[0].arrays["a"].dtype
  pa, pb = sr_mod.contraction_pads(key.op, dtype)
  boolean = sr_mod.get(key.op).boolean
  if boolean:
    pa = pb = False
  (has_c,) = key.params
  a = np.stack([_pad2d(r.arrays["a"], mb, kb, pa, pa) for r in reqs])
  b = np.stack([_pad2d(r.arrays["b"], kb, nb, pb, pb) for r in reqs])
  # per-request live-K: lanes beyond a request's true K are contraction pads
  kv = np.asarray([r.shape[1] for r in reqs], np.int32)
  if not has_c:
    return (a, b, kv)
  ident = False if boolean else sr_mod.oplus_identity(
      key.op, reqs[0].arrays["c"].dtype)
  c = np.stack([_pad2d(r.arrays["c"], mb, nb, ident, ident) for r in reqs])
  return (a, b, c, kv)


def _stack_closure(key: BucketKey, reqs: Sequence[ProblemRequest]):
  (nb,) = key.shape
  adj = np.stack([cl_mod.pad_adjacency(r.arrays["adj"], nb, op=key.op)
                  for r in reqs])
  # true problem sizes: rows/cols beyond valid[r] are isolated-vertex padding
  valid = np.asarray([r.shape[0] for r in reqs], np.int32)
  return (adj, valid)


def _stack_knn(key: BucketKey, reqs: Sequence[ProblemRequest]):
  qb, rb, db = key.shape
  # all pads are zeros (query pad rows' outputs are sliced away; padded dims
  # contribute (0-0)²=0 for real rows); ``valid`` carries each request's true
  # corpus size so padded rows can be masked out of top-k.
  q = np.stack([_pad2d(r.arrays["queries"], qb, db, 0.0, 0.0) for r in reqs])
  ref = np.stack([_pad2d(r.arrays["corpus"], rb, db, 0.0, 0.0) for r in reqs])
  valid = np.asarray([r.arrays["corpus"].shape[0] for r in reqs], np.int32)
  return (q, ref, valid)


def stack_batch(key: BucketKey, reqs: Sequence[ProblemRequest]):
  """Pad + stack all request operands for one bucket batch."""
  if key.kind == "mmo":
    return _stack_mmo(key, reqs)
  if key.kind == "closure":
    return _stack_closure(key, reqs)
  if key.kind == "knn":
    return _stack_knn(key, reqs)
  raise ValueError(f"unknown kind {key.kind!r}")


def abstract_batch(key: BucketKey, batch: int) -> tuple:
  """``ShapeDtype``s matching ``stack_batch``'s output for ``batch``
  requests."""
  i32 = np.dtype(np.int32)
  if key.kind == "mmo":
    mb, kb, nb = key.shape
    (has_c,) = key.params
    shapes = [(batch, mb, kb), (batch, kb, nb)]
    if has_c:
      shapes.append((batch, mb, nb))
    return tuple(ShapeDtype(s, np.dtype(dt))
                 for s, dt in zip(shapes, key.dtypes)) + (
        ShapeDtype((batch,), i32),)
  if key.kind == "closure":
    (nb,) = key.shape
    return (ShapeDtype((batch, nb, nb), np.dtype(key.dtypes[0])),
            ShapeDtype((batch,), i32))
  if key.kind == "knn":
    qb, rb, db = key.shape
    return (ShapeDtype((batch, qb, db), np.dtype(key.dtypes[0])),
            ShapeDtype((batch, rb, db), np.dtype(key.dtypes[1])),
            ShapeDtype((batch,), i32))
  raise ValueError(f"unknown kind {key.kind!r}")


def to_device(stacked, device) -> tuple:
  """Host-to-device copy of one stacked batch."""
  return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
               for x in stacked)


# ---------------------------------------------------------------------------
# batch-function construction
# ---------------------------------------------------------------------------


def make_batch_fn(key: BucketKey, *, backend: str, device, block: tuple = (),
                  mesh=None, schedule: str = "local"):
  """Function over the stacked device operands for one bucket.

  ``backend``/``block`` are the bucket's dispatch decision, baked into the
  executable-cache key.  ``backend="megakernel"`` serves closure buckets
  through the fused fixpoint K2, with the chunk length G taken from
  ``block[0]`` (default 8); ``mmo`` refuses it for single contractions.
  Building for a kernel arm on a card also loads (building if needed) the
  kernel's library, so the first batch pays no build.

  ``schedule`` places the bucket: ``"local"`` runs the single-device
  entry points on ``device``; a name from ``core.distributed.SCHEDULES``
  runs the same work over ``mesh`` (kspan, SUMMA and ring shard the
  problem axes, ``"dp"`` the request axis: for closures, one independent
  fixpoint per shard), with ``backend`` as each shard's contraction and the
  ragged ``k_valid``/``valid_n`` masks carried through.  A ``'megakernel'``
  decision on a mesh-routed closure bucket runs its shards on ``'pallas'``
  (K1): the fused arm is a single-device program.  (The reference's
  shards fall back to ``'xla'`` there; the port's ``'xla'`` arm for the
  min/max rings is plain tensor code, which would hide the kernel.)
  """
  sharded = schedule != "local"
  if sharded and mesh is None:
    raise ValueError(f"schedule {schedule!r} needs a mesh")
  local_bk = backend
  if sharded and backend == "megakernel":
    # K2's chunk length G is no block config of K1's: the shards take none
    local_bk, block = "pallas", ()
  if torch.device(device).type == "cuda":
    if local_bk == "pallas":
      from repro_torch.kernels.semiring_mmo import load
      load()
    elif local_bk == "megakernel":
      from repro_torch.kernels import closure_megakernel as _mk
      _mk.load()

  if sharded:
    from repro_torch.core import distributed as dist

    def contract(a, b, c, op, kv):
      return dist.mmo_sharded_batched(a, b, c, op=op, schedule=schedule,
                                      mesh=mesh, backend=local_bk,
                                      block=block, k_valid=kv)
  else:

    def contract(a, b, c, op, kv):
      return mmo_batched(a, b, c, op=op, backend=backend, block=block,
                         k_valid=kv)

  if key.kind == "mmo":
    (has_c,) = key.params

    def fn(*args):
      a, b = args[0], args[1]
      c = args[2] if has_c else None
      kv = args[2 + has_c]
      return contract(a, b, c, key.op, kv)

    return fn

  if key.kind == "closure":
    (algorithm,) = key.params
    if sharded:

      def fn(adj, valid):
        return dist.sharded_closure_batched(adj, op=key.op,
                                            algorithm=algorithm, mesh=mesh,
                                            schedule=schedule,
                                            backend=local_bk, block=block,
                                            valid_n=valid)

      return fn

    solver = (cl_mod.batched_leyzorek_closure if algorithm == "leyzorek"
              else cl_mod.batched_bellman_ford_closure)

    if backend == "megakernel":
      g = int(block[0]) if block else 8

      def fn(adj, valid):
        return solver(adj, op=key.op, fixpoint_backend="megakernel",
                      megakernel_g=g, valid_n=valid)

      return fn

    def mmo_fn(a, b, c, op, bk, k_valid=None):
      return mmo(a, b, c, op=op, backend=bk, block=block, k_valid=k_valid)

    def fn(adj, valid):
      return solver(adj, op=key.op, backend=backend, mmo_fn=mmo_fn,
                    valid_n=valid)

    return fn

  if key.kind == "knn":
    (k,) = key.params

    def fn(q, ref, valid):
      d2 = contract(q, ref.transpose(-1, -2), None, "addnorm",
                    None)  # feature dim is never padded raggedly
      # mask padded corpus rows to +inf so they lose every top-k comparison
      row_ok = torch.arange(d2.shape[-1], device=d2.device) < valid[:, None]
      # repro: ignore[semiring-hardcoded-identity] — top-k mask, not a pad
      d2 = torch.where(row_ok[:, None, :], d2, float("inf"))
      return smallest_k(d2, k)

    return fn

  raise ValueError(f"unknown kind {key.kind!r}")


def _primary_output(key: BucketKey, out):
  """The batch output array callers consume as the result value."""
  return out[0] if isinstance(out, (tuple, list)) else out


def validate_finite(key: BucketKey, out, live: int):
  """NaN scan over the primary output's first ``live`` slots; returns the
  offending request-slot indices (empty = clean).

  Only NaN counts as garbage: ±inf is a legitimate value in tropical
  semirings (APSP spells "unreachable" as +inf).  Boolean outputs cannot
  carry NaN and always validate clean."""
  arr = np.asarray(_primary_output(key, out))
  if not np.issubdtype(arr.dtype, np.floating) or live < 1:
    return []
  # one NaN-propagating reduction decides clean batches; per-slot
  # attribution only runs on a hit
  if not np.isnan(np.min(arr[:live])):
    return []
  bad = np.isnan(arr[:live]).any(axis=tuple(range(1, arr.ndim)))
  return [int(i) for i in np.nonzero(bad)[0]]


def poison_output(key: BucketKey, out, slots: Sequence[int]):
  """Overwrite the primary output's ``slots`` with NaN — the fault
  injector's ``nonfinite`` point (faults.py), which the engine's result
  validation must catch.  Returns a rebuilt output structure; non-float
  primaries (boolean rings) pass through unpoisoned."""
  primary = np.asarray(_primary_output(key, out))
  if not np.issubdtype(primary.dtype, np.floating) or not len(slots):
    return out
  primary = primary.copy()
  primary[list(slots)] = np.nan
  if isinstance(out, (tuple, list)):
    return (primary,) + tuple(out[1:])
  return primary


def split_results(key: BucketKey, reqs: Sequence[ProblemRequest], out):
  """Batch output (numpy) → per-request MMOResults at true shapes."""
  results = []
  if key.kind == "mmo":
    d = np.asarray(out)
    for i, r in enumerate(reqs):
      m, _, n = r.shape
      results.append(MMOResult(value=d[i, :m, :n]))
  elif key.kind == "closure":
    closed, iters = (np.asarray(out[0]), np.asarray(out[1]))
    for i, r in enumerate(reqs):
      (n,) = r.shape
      results.append(MMOResult(value=closed[i, :n, :n],
                               extras={"iterations": int(iters[i])}))
  elif key.kind == "knn":
    d2, idx = np.asarray(out[0]), np.asarray(out[1])
    for i, r in enumerate(reqs):
      q = r.shape[0]
      results.append(MMOResult(value=d2[i, :q], extras={"indices": idx[i, :q]}))
  else:
    raise ValueError(f"unknown kind {key.kind!r}")
  return results
