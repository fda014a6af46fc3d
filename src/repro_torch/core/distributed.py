"""Distributed SIMD² — semiring matmuls and closures on a device mesh.

Counterpart of ``repro/core/distributed.py``.  Every SIMD² ⊕ is one of
{+, min, max, or}, so a K-sharded contraction needs only a generalized
all-reduce (``core.semiring.oplus_allreduce``; one controller needs only
its reduce half, ``oplus_reduce_parts``).  The schedules:

  * ``mmo_kspan`` — K-sharded along one axis: local partial contraction,
    then one ⊕-reduction.  Least traffic when K is the big axis.
  * ``summa_mmo`` — 2-D blocked SUMMA: A's row panel all-gathered along
    the column axis, B's column panel along the row axis, a local
    contraction of an (M/p, K) × (K, N/q) block per shard.  The iterate of
    a squaring closure stays 2-D-sharded in place (``distributed_leyzorek``).
  * ``ring_mmo`` — B's K-chunks rotate around a ring of shards; shard j owns
    output columns N_j and ⊕-accumulates one chunk's contribution per step.

Each has a batched form over a leading request axis, the serving engine's
sharded bucket path: kspan, SUMMA and ring shard the problem axes and keep
every request on every shard, so per-request ``k_valid`` masks still work
(K-sharded schedules rebase them per shard and per step, and a shard whose
chunk lies wholly past a request's live lanes gets ``k_valid = 0``);
``dp`` shards the request axis over every shard and needs no collective.
``sharded_closure_batched`` runs the batched fixpoints with each step as a
mesh schedule, or, for dp, one independent fixpoint per shard.

Single controller.  The reference ``shard_map``s one SPMD program over the
mesh, and every line of shards along an axis that kspan or ring leaves
unsharded computes the same whole product.  Here one process issues each
shard's program onto its device, and issues only the first such line: the
others' replicas would compute what it computes, for nobody to read.

  * a shard's operands are materialised on its device as contiguous
    tensors; its contraction is ``core.mmo.mmo`` on the given ``backend``
    (on a card, ``'pallas'`` is K1: per call, mesh.size launches for SUMMA
    and dp, p for kspan and p × p for ring, p the shards along its axis);
  * an all-gather is a ``torch.cat`` of peer copies, a ppermute a copy to
    the next shard, the ⊕-all-reduce a reduction of peer copies onto the
    first shard, the one the result is read from;
  * every shard's work is issued before any host sync, so shards on
    distinct cards overlap; results are assembled on the input's device.

The contraction schedules return, for the min/max rings and orand, the
bits of the single-device contraction (⊕ is order-free); mma and addnorm
sum their K-chunks in another order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.core.mmo import mmo as _mmo

Tensor = torch.Tensor

SCHEDULES = ("dp", "kspan", "summa", "ring")


# ---------------------------------------------------------------------------
# mesh geometry and data movement
# ---------------------------------------------------------------------------


def _axis_pos(mesh, axis: str) -> int:
  try:
    return mesh.axis_names.index(axis)
  except ValueError:
    raise ValueError(f"the mesh has no axis {axis!r}; its axes are "
                     f"{mesh.axis_names}") from None


def _device(mesh, axis: str, idx: int, other: int) -> torch.device:
  """The shard at index ``idx`` along ``axis`` and ``other`` along the
  other axis."""
  if _axis_pos(mesh, axis) == 1:
    return mesh.devices[other][idx]
  return mesh.devices[idx][other]


def _line(mesh, axis: str) -> list:
  """The first line of shards along ``axis`` (index 0 of the other axis),
  in ``axis`` order: the one kspan and ring issue."""
  return [_device(mesh, axis, i, 0) for i in range(mesh.shape[axis])]


def _chunk(size: int, parts: int, what: str) -> int:
  if size % parts:
    raise ValueError(f"the {what} axis ({size}) does not split evenly over "
                     f"{parts} shards")
  return size // parts


def _on(x: Tensor, device) -> Tensor:
  """``x`` on ``device`` as a contiguous tensor: a peer copy where it lies
  elsewhere."""
  return x.to(device, non_blocking=True).contiguous()


def _piece(x: Tensor, dim: int, i: int, size: int) -> Tensor:
  return x.narrow(dim, i * size, size)


def _kv(k_valid, device) -> Optional[Tensor]:
  if k_valid is None:
    return None
  return torch.as_tensor(k_valid, dtype=torch.int32, device=device)


def _rebase(kv: Optional[Tensor], start: int, k_chunk: int, device):
  """A per-request live-K count rebased onto the K-chunk
  [start, start + k_chunk) and placed on ``device``: lanes before the chunk
  are another shard's, lanes past the count are pads either way."""
  if kv is None:
    return None
  return _on((kv - start).clamp(0, k_chunk), device)


def _contract(a, b, c, op, backend, block, kv):
  return _mmo(a, b, c, op=op, backend=backend, block=block or None,
              k_valid=kv)


def _fold_c(sr, out: Tensor, c: Optional[Tensor]) -> Tensor:
  if c is None:
    return out
  return sr.oplus(out, _on(c, out.device).to(out.dtype))


# ---------------------------------------------------------------------------
# the three contraction schedules, over any leading request dims
# ---------------------------------------------------------------------------


def _kspan(a, b, c, *, op, mesh, axis, backend, block, k_valid):
  sr = sr_mod.get(op)
  p = mesh.shape[axis]
  k_chunk = _chunk(a.shape[-1], p, "K")
  kv = _kv(k_valid, a.device)
  parts = [_contract(_on(_piece(a, -1, i, k_chunk), dev),
                     _on(_piece(b, -2, i, k_chunk), dev), None, op, backend,
                     block, _rebase(kv, i * k_chunk, k_chunk, dev))
           for i, dev in enumerate(_line(mesh, axis))]
  # every shard's partial is issued; now one ⊕-reduction onto shard 0
  full = sr_mod.oplus_reduce_parts(sr, parts)
  return _fold_c(sr, full, c).to(a.device)


def _block_device(mesh, row_axis, col_axis, i, j):
  return _device(mesh, row_axis, i, j) if _axis_pos(mesh, row_axis) == 0 \
      else _device(mesh, col_axis, j, i)


def _scatter2d(x: Tensor, mesh, row_axis, col_axis, what) -> dict:
  """The (i, j) blocks of ``x``'s last two dims, rows split over
  ``row_axis`` and columns over ``col_axis``, each on its shard."""
  rows, cols = mesh.shape[row_axis], mesh.shape[col_axis]
  rb = _chunk(x.shape[-2], rows, f"{what} row")
  cb = _chunk(x.shape[-1], cols, f"{what} column")
  return {(i, j): _on(_piece(_piece(x, -2, i, rb), -1, j, cb),
                      _block_device(mesh, row_axis, col_axis, i, j))
          for i in range(rows) for j in range(cols)}


def _gather2d(blocks: dict, rows: int, cols: int, device) -> Tensor:
  return torch.cat([torch.cat([blocks[(i, j)].to(device) for j in range(cols)],
                              dim=-1) for i in range(rows)], dim=-2)


def _summa_blocks(a_blk, b_blk, c_blk, *, op, mesh, row_axis, col_axis,
                  backend, block, kv):
  """One SUMMA product on 2-D-sharded blocks: shard (i, j) all-gathers A's
  row panel i and B's column panel j, contracts, and folds C's block."""
  sr = sr_mod.get(op)
  rows, cols = mesh.shape[row_axis], mesh.shape[col_axis]
  out = {}
  for i in range(rows):
    for j in range(cols):
      dev = _block_device(mesh, row_axis, col_axis, i, j)
      a_row = torch.cat([a_blk[(i, jj)].to(dev, non_blocking=True)
                         for jj in range(cols)], dim=-1)
      b_col = torch.cat([b_blk[(ii, j)].to(dev, non_blocking=True)
                         for ii in range(rows)], dim=-2)
      d = _contract(a_row, b_col, None, op, backend, block,
                    None if kv is None else _on(kv, dev))
      out[(i, j)] = d if c_blk is None else sr.oplus(d, c_blk[(i, j)].to(
          d.dtype))
  return out


def _summa(a, b, c, *, op, mesh, row_axis, col_axis, backend, block,
           k_valid):
  rows, cols = mesh.shape[row_axis], mesh.shape[col_axis]
  a_blk = _scatter2d(a, mesh, row_axis, col_axis, "A")
  b_blk = _scatter2d(b, mesh, row_axis, col_axis, "B")
  c_blk = None if c is None else _scatter2d(c, mesh, row_axis, col_axis, "C")
  out = _summa_blocks(a_blk, b_blk, c_blk, op=op, mesh=mesh,
                      row_axis=row_axis, col_axis=col_axis, backend=backend,
                      block=block, kv=_kv(k_valid, a.device))
  return _gather2d(out, rows, cols, a.device)


def _ring(a, b, c, *, op, mesh, axis, backend, block, k_valid):
  sr = sr_mod.get(op)
  p = mesh.shape[axis]
  k_chunk = _chunk(b.shape[-2], p, "K")
  n_cols = _chunk(b.shape[-1], p, "N")
  if a.shape[-1] != b.shape[-2]:
    raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                     f"{tuple(b.shape)}")
  kv = _kv(k_valid, a.device)
  line = _line(mesh, axis)
  a_rep = [_on(a, dev) for dev in line]  # A is replicated
  b_cur = [_on(_piece(b, -2, i, k_chunk), dev) for i, dev in enumerate(line)]
  acc = [None] * p
  for step in range(p):
    for i, dev in enumerate(line):
      src = (i - step) % p  # the chunk held here came from shard src
      part = _contract(_on(_piece(a_rep[i], -1, src, k_chunk), dev),
                       _on(_piece(b_cur[i], -1, i, n_cols), dev), None, op,
                       backend, block, _rebase(kv, src * k_chunk, k_chunk, dev))
      acc[i] = part if acc[i] is None else sr.oplus(acc[i], part)
    if step + 1 < p:  # ppermute: shard i passes its chunk to shard i + 1
      b_cur = [b_cur[(i - 1) % p].to(dev, non_blocking=True)
               for i, dev in enumerate(line)]
  if c is not None:
    acc = [_fold_c(sr, acc[i], _piece(c, -1, i, n_cols)) for i in range(p)]
  return torch.cat([x.to(a.device) for x in acc], dim=-1)


# ---------------------------------------------------------------------------
# unbatched schedules (a single (M, K) × (K, N) contraction)
# ---------------------------------------------------------------------------


def mmo_kspan(a: Tensor, b: Tensor, c: Optional[Tensor], *, op: str, mesh,
              axis: str = "model", backend: str = "auto") -> Tensor:
  """K-sharded contraction + ⊕-all-reduce along ``axis``: A (M, K) and
  B (K, N) sharded on K; C and D replicated."""
  return _kspan(a, b, c, op=op, mesh=mesh, axis=axis, backend=backend,
                block=None, k_valid=None)


def summa_mmo(a: Tensor, b: Tensor, c: Optional[Tensor], *, op: str, mesh,
              row_axis: str = "data", col_axis: str = "model",
              backend: str = "auto") -> Tensor:
  """2-D SUMMA: operands and result block-sharded (row_axis, col_axis)."""
  return _summa(a, b, c, op=op, mesh=mesh, row_axis=row_axis,
                col_axis=col_axis, backend=backend, block=None, k_valid=None)


def ring_mmo(a: Tensor, b: Tensor, c: Optional[Tensor], *, op: str, mesh,
             axis: str = "model", backend: str = "auto") -> Tensor:
  """1-D ring: A replicated, B K-sharded along ``axis`` and rotating;
  shard j owns output columns N_j."""
  return _ring(a, b, c, op=op, mesh=mesh, axis=axis, backend=backend,
               block=None, k_valid=None)


# ---------------------------------------------------------------------------
# batched schedules (a leading request axis) — the engine's sharded path
# ---------------------------------------------------------------------------


def mmo_dp_batched(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                   op: str, mesh, backend: str = "xla",
                   block: Optional[tuple] = None, k_valid=None) -> Tensor:
  """Requests sharded over every shard in row-major order, each shard
  contracting its R/P requests: no collective.  R must divide by the
  mesh's size (the engine serves partial batches locally)."""
  r = a.shape[0]
  if r % mesh.size:
    raise ValueError(f"dp needs the request axis ({r}) divisible by the "
                     f"mesh's {mesh.size} devices")
  per = r // mesh.size
  kv = _kv(k_valid, a.device)
  outs = []
  for s, dev in enumerate(mesh.flat):
    sl = slice(s * per, (s + 1) * per)
    outs.append(_contract(_on(a[sl], dev), _on(b[sl], dev),
                          None if c is None else _on(c[sl], dev), op,
                          backend, block,
                          None if kv is None else _on(kv[sl], dev)))
  return torch.cat([o.to(a.device) for o in outs])


def mmo_kspan_batched(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                      op: str, mesh, axis: str = "model",
                      backend: str = "xla", block: Optional[tuple] = None,
                      k_valid=None) -> Tensor:
  """Batched K-sharded contraction + ⊕-all-reduce along ``axis``."""
  return _kspan(a, b, c, op=op, mesh=mesh, axis=axis, backend=backend,
                block=block, k_valid=k_valid)


def summa_mmo_batched(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                      op: str, mesh, row_axis: str = "data",
                      col_axis: str = "model", backend: str = "xla",
                      block: Optional[tuple] = None,
                      k_valid=None) -> Tensor:
  """Batched 2-D SUMMA; K is whole after the gathers, so ``k_valid``
  applies unrebased."""
  return _summa(a, b, c, op=op, mesh=mesh, row_axis=row_axis,
                col_axis=col_axis, backend=backend, block=block,
                k_valid=k_valid)


def ring_mmo_batched(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                     op: str, mesh, axis: str = "model", backend: str = "xla",
                     block: Optional[tuple] = None, k_valid=None) -> Tensor:
  """Batched 1-D ring; ``k_valid`` is rebased onto each step's chunk."""
  return _ring(a, b, c, op=op, mesh=mesh, axis=axis, backend=backend,
               block=block, k_valid=k_valid)


def mmo_sharded_batched(a: Tensor, b: Tensor, c: Optional[Tensor] = None, *,
                        op: str, schedule: str, mesh, backend: str = "xla",
                        block: Optional[tuple] = None,
                        k_valid=None) -> Tensor:
  """One batched mesh schedule by name — the engine's sharded entry point.

  The mesh's first axis is the SUMMA row axis, its last the SUMMA column,
  K-span and ring axis (a (1, p) mesh runs kspan and ring over all p shards
  and SUMMA as a 1 × p column split).
  """
  row_axis, col_axis = mesh.axis_names[0], mesh.axis_names[-1]
  kw = dict(op=op, mesh=mesh, backend=backend, block=block, k_valid=k_valid)
  if schedule == "dp":
    return mmo_dp_batched(a, b, c, **kw)
  if schedule == "kspan":
    return mmo_kspan_batched(a, b, c, axis=col_axis, **kw)
  if schedule == "summa":
    return summa_mmo_batched(a, b, c, row_axis=row_axis, col_axis=col_axis,
                             **kw)
  if schedule == "ring":
    return ring_mmo_batched(a, b, c, axis=col_axis, **kw)
  raise ValueError(f"unknown schedule {schedule!r}; pick from {SCHEDULES}")


def schedule_fits(schedule: str, m: int, k: int, n: int, mesh) -> bool:
  """Whether a contraction's problem axes divide evenly onto the mesh for
  one schedule (dp's request axis is checked per batch by the engine)."""
  rows, cols = mesh.shape[mesh.axis_names[0]], mesh.shape[mesh.axis_names[-1]]
  if schedule == "dp":
    return True
  if schedule == "kspan":
    return k % cols == 0
  if schedule == "summa":
    # K is split over cols on A and over rows on B before the all-gathers
    return (m % rows == 0 and n % cols == 0
            and k % rows == 0 and k % cols == 0)
  if schedule == "ring":
    return k % cols == 0 and n % cols == 0
  return False


# ---------------------------------------------------------------------------
# sharded closures
# ---------------------------------------------------------------------------


def _local_mmo_fn(block: Optional[tuple]):
  """Shard-local step honouring a block config; None for the solver's own
  default step."""
  if not block:
    return None

  def mmo_fn(a, b, c, op_, bk, k_valid=None):
    return _mmo(a, b, c, op=op_, backend=bk, block=block, k_valid=k_valid)

  return mmo_fn


def _sched_mmo_fn(schedule: str, mesh, backend: str,
                  block: Optional[tuple]):
  """The closure solvers' step, swapped for one mesh schedule."""

  def mmo_fn(a, b, c, op_, bk, k_valid=None):
    del bk  # the solver echoes ``backend``
    return mmo_sharded_batched(a, b, c, op=op_, schedule=schedule, mesh=mesh,
                               backend=backend, block=block, k_valid=k_valid)

  return mmo_fn


def _dp_closure(adj, *, op, algorithm, mesh, backend, block, max_iters,
                valid_n):
  """One independent batched fixpoint per shard over its R/P requests.

  Every running shard advances one step, then one host sync reads all of
  their active flags at once; a shard stops as soon as its own requests
  converge (or its budget runs out), so a straggler holds back only its
  own shard."""
  from repro_torch.core import closure as cl

  per = adj.shape[0] // mesh.size
  vn = _kv(valid_n, adj.device)
  shards = []
  for s, dev in enumerate(mesh.flat):
    sl = slice(s * per, (s + 1) * per)
    c0, step, budget = cl._dispatch_fixpoint(
        _on(adj[sl], dev), op=op, algorithm=algorithm, max_iters=max_iters,
        backend=backend, mmo_fn=_local_mmo_fn(block))
    state = cl._fixpoint_state(c0, None if vn is None else _on(vn[sl], dev))
    shards.append({"state": state, "step": step, "budget": budget, "i": 0})
  running = [sh for sh in shards if sh["budget"] > 0]
  while running:
    for sh in running:
      sh["state"] = cl._fixpoint_step(sh["state"], sh["step"])
      sh["i"] += 1
    at = running[0]["state"][1].device
    flags = torch.stack([sh["state"][1].any().to(at, non_blocking=True)
                         for sh in running]).tolist()
    running = [sh for sh, live in zip(running, flags)
               if live and sh["i"] < sh["budget"]]
  closed = torch.cat([sh["state"][0].to(adj.device) for sh in shards])
  iters = torch.cat([sh["state"][2].to(adj.device) for sh in shards])
  return closed, iters


def sharded_closure_batched(adj: Tensor, *, op: str,
                            algorithm: str = "leyzorek", mesh,
                            schedule: str = "summa", backend: str = "xla",
                            block: Optional[tuple] = None,
                            max_iters: Optional[int] = None, valid_n=None):
  """Batched semiring fixpoint with the mesh schedule threaded through.

  kspan, SUMMA and ring reuse the batched solvers (per-request convergence
  masks, converged requests at ``k_valid = 0``) with each step a mesh
  schedule.  ``"dp"`` shards the request axis and runs one independent
  fixpoint per shard; it equals the local batched closure output for
  output and iteration count for iteration count.  Returns (closure,
  per-request iterations).  The fused arm K2 is a single-device program,
  so ``backend="megakernel"`` is refused here: a mesh runs K1 per shard
  (``'pallas'``).
  """
  if backend == "megakernel":
    raise ValueError("the fused arm is a single-device program: run a mesh "
                     "schedule's shards on 'pallas' (K1)")
  if algorithm not in ("leyzorek", "bellman_ford"):
    raise ValueError(f"unknown closure algorithm {algorithm!r}")
  if schedule == "dp":
    if adj.shape[0] % mesh.size:
      raise ValueError(f"dp needs the request axis ({adj.shape[0]}) "
                       f"divisible by the mesh's {mesh.size} devices")
    return _dp_closure(adj, op=op, algorithm=algorithm, mesh=mesh,
                       backend=backend, block=block, max_iters=max_iters,
                       valid_n=valid_n)
  if schedule not in SCHEDULES:
    raise ValueError(f"unknown schedule {schedule!r}; pick from {SCHEDULES}")
  from repro_torch.core import closure as cl
  solver = (cl.batched_leyzorek_closure if algorithm == "leyzorek"
            else cl.batched_bellman_ford_closure)
  return solver(adj, op=op, backend=backend,
                mmo_fn=_sched_mmo_fn(schedule, mesh, backend, block),
                max_iters=max_iters, valid_n=valid_n)


def distributed_leyzorek(adj: Tensor, *, op: str, mesh,
                         row_axis: str = "data", col_axis: str = "model",
                         max_iters: Optional[int] = None,
                         backend: str = "auto") -> Tensor:
  """C ← C ⊕ (C ⊗ C), lg n times, with C 2-D-sharded across the mesh the
  whole time: only the SUMMA panels move between shards each iteration."""
  n = adj.shape[-1]
  iters = max_iters if max_iters is not None else max(
      1, math.ceil(math.log2(max(n, 2))))
  blocks = _scatter2d(adj, mesh, row_axis, col_axis, "C")
  for _ in range(iters):
    blocks = _summa_blocks(blocks, blocks, blocks, op=op, mesh=mesh,
                           row_axis=row_axis, col_axis=col_axis,
                           backend=backend, block=None, kv=None)
  return _gather2d(blocks, mesh.shape[row_axis], mesh.shape[col_axis],
                   adj.device)
