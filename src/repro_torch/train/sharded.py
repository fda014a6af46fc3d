"""Training state cut over a mesh: the all-gather and the gradient sums
of the train step.

Port-only: it takes the place of the reference's GSPMD collectives
(``repro/launch/train.py``, ``repro/train/steps.py``) on the
single-controller ``launch.mesh.Mesh`` that ``core/distributed.py`` and
``models/pipeline.py`` use.  One process holds every shard's tensors on
the shard's device and moves them with peer copies.  Placement (specs,
pieces, replicas) is ``models/placement.py``'s; replicas are kept equal by
computing each one in the same order.

  * ``shard_tree`` — cut a tree of whole tensors onto the mesh;
  * ``gather_tree`` — the whole leaves on one device (the all-gather), cast
    on the way when a dtype is given;
  * ``PositionGrads`` — the tensor-parallel step's gradient sums: each
    mesh position's gradient of the part of a leaf it computed with, added
    into the owners' pieces during the backward (a leaf cut over the model
    axis), or summed over the line's positions in position order and added
    into every replica alike (a leaf replicated over it); rounded to bf16
    for the copy when asked;
  * ``ShardedState`` — the f32 master and AdamW's ``m`` and ``v`` under the
    parameters' specs, and the replicated step count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.common import tree_paths
from repro_torch.models.placement import (Sharded, assemble, names,
                                          positions, shard_leaf, shard_tree)
from repro_torch.roofline import collectives
from repro_torch.train.optimizer import _leaves, tree_map

Tensor = torch.Tensor


def gather_leaf(x: Sharded, device, dtype: Optional[torch.dtype] = None
                ) -> Tensor:
  """The whole leaf on ``device``, in ``dtype`` (default its own).  A
  piece that is the whole leaf, on ``device`` and in ``dtype``, is
  returned as it is, not copied."""
  device, dtype = torch.device(device), dtype or x.dtype
  for pos in x.distinct():
    p = x.pieces[pos]
    if (tuple(p.shape) == tuple(x.shape) and p.device == device
        and p.dtype == dtype):
      return p
  return assemble(tuple(slice(0, n) for n in x.shape),
                  [(x.box(pos), x.pieces[pos]) for pos in x.distinct()],
                  device, dtype)


def gather_tree(sharded, device, dtype: Optional[torch.dtype] = None):
  """The whole leaves of a tree of ``Sharded`` on ``device``, cast to
  ``dtype`` on the way when given (floating leaves only)."""
  def one(x):
    cast = dtype if dtype is not None and x.dtype.is_floating_point else None
    return gather_leaf(x, device, cast)
  return tree_map(one, sharded)


def _overlap(box: tuple, other: tuple):
  """(slices of ``box``'s tensor, slices of ``other``'s) where the two
  boxes of one leaf meet; None where they do not."""
  cut = [slice(max(a.start, b.start), min(a.stop, b.stop))
         for a, b in zip(box, other)]
  if any(c.start >= c.stop for c in cut):
    return None
  return (tuple(slice(c.start - a.start, c.stop - a.start)
                for c, a in zip(cut, box)),
          tuple(slice(c.start - b.start, c.stop - b.start)
                for c, b in zip(cut, other)))


class PositionGrads:
  """A tensor-parallel step's gradient sums in the master's layout, fed by
  the mesh positions during the backward (``zoo.ShardedLM(grads=...)``).

  ``acc`` is a tree of ``Sharded`` f32 sums cut like ``like`` (the
  master).  A piece is made by the first copy added into it, so the sums
  take memory only as the backward produces them, as one device's
  gradients do; ``fill`` zeroes the pieces nothing reached (a leaf the
  batch does not use).  ``add(path, pos, box, grad)`` takes position
  ``pos``'s gradient of the part ``box`` (slices of the whole leaf) it
  computed with:
    * a leaf cut over the model axis: the part is added at once into every
      piece it overlaps (its owners along ``data``, or its replicas there
      when the leaf is not cut along ``data``).  The lines' backwards run
      one after another in line order, so each piece sums the lines in
      that order;
    * a leaf replicated over the model axis (norm scales, the router,
      ``bc_proj``, the per-head SSM leaves, k/v projections when tp does
      not divide the kv heads): the parts are held until the line's
      backward ends (``flush``), then summed over their boxes in position
      order in f32, and the sum is added into every replica alike, so the
      replicas stay bit-equal.
  With ``bf16`` each copy is rounded to bf16 before it is added
  (``grad_comm_bf16``).

  To a ``roofline.collectives.CollectiveCounter`` that is on, each copy
  into the pieces along the data axes is a reduce-scatter over them (a
  leaf cut along ``data``, ``grad_reduce_scatter``) or an all-reduce (a
  leaf replicated there, ``grad_all_reduce``) of the part, in the copy's
  dtype; a flushed leaf's sum over the line is besides an f32 all-reduce
  of the whole leaf over the model axis (``grad_all_reduce``).
  """

  def __init__(self, like, model_axis: str, bf16: bool = False):
    self.acc = tree_map(lambda x: Sharded(
        x.shape, torch.float32, x.spec, x.mesh,
        {pos: None for pos in positions(x.mesh)}), like)
    self.model_axis, self.bf16 = model_axis, bf16
    self.leaves = tree_paths(self.acc)
    self._held: dict = {}

  def _cut_over_model(self, x: Sharded) -> bool:
    return any(self.model_axis in names(e) for e in x.spec)

  def _report(self, x: Sharded, pos: tuple, numel: int) -> None:
    """The copy of ``numel`` gradient elements of ``x`` from position
    ``pos`` into the pieces along the data axes."""
    data = [a for a in x.mesh.axis_names if a != self.model_axis]
    over = any(a in data for e in x.spec for a in names(e))
    collectives.record(
        "grad_reduce_scatter" if over else "grad_all_reduce",
        "+".join(data), "reduce-scatter" if over else "all-reduce",
        numel * (2 if self.bf16 else 4), len(x.mesh.devices), pos)

  def add(self, path: str, pos: tuple, box: tuple, grad: Tensor) -> None:
    x = self.leaves[path]
    if self._cut_over_model(x):
      if collectives.counting():
        self._report(x, pos, grad.numel())
      self._scatter(x, box, grad)
      return
    held = self._held.setdefault(path, {})
    if pos in held:
      held[pos] = (box, held[pos][1] + grad.float())
    else:
      held[pos] = (box, grad.float())

  def flush(self) -> None:
    """Sum the held parts of a line that has finished its backward."""
    for path, held in self._held.items():
      x = self.leaves[path]
      if collectives.counting():
        for pos in held:
          collectives.record("grad_all_reduce", self.model_axis,
                             "all-reduce", x.shape.numel() * 4,
                             len(x.mesh.devices[0]), pos)
          self._report(x, pos, x.shape.numel())
      dev = held[min(held)][1].device
      total = torch.zeros(x.shape, dtype=torch.float32, device=dev)
      for pos in sorted(held):
        box, g = held[pos]
        total[box] += g.to(dev)
      self._scatter(x, tuple(slice(0, n) for n in x.shape), total)
    self._held = {}

  def fill(self) -> None:
    """Zero pieces for the parts no gradient reached."""
    for x in _leaves(self.acc):
      for pos, p in x.pieces.items():
        if p is None:
          dev = x.mesh.devices[pos[0]][pos[1]]
          x.pieces[pos] = torch.zeros(
              [s.stop - s.start for s in x.box(pos)], dtype=torch.float32,
              device=dev)

  def _scatter(self, x: Sharded, box: tuple, grad: Tensor) -> None:
    for pos in positions(x.mesh):
      own = x.box(pos)
      cut = _overlap(box, own)
      if cut is None:
        continue
      part = grad[cut[0]]
      if self.bf16:
        part = part.to(torch.bfloat16)
      dev = x.mesh.devices[pos[0]][pos[1]]
      if x.pieces[pos] is None:
        if all(c.stop - c.start == o.stop - o.start
               for c, o in zip(cut[1], own)):
          # a copy: replicas must not share storage
          x.pieces[pos] = part.to(dev, torch.float32, copy=True
                                  ).contiguous()
          continue
        x.pieces[pos] = torch.zeros([o.stop - o.start for o in own],
                                    dtype=torch.float32, device=dev)
      dst = x.pieces[pos][cut[1]]
      dst.add_(part.to(dst.device, non_blocking=True))


def tree_local_bytes(sharded, pos: tuple) -> int:
  """Bytes of the pieces position ``pos`` holds, over a tree's leaves."""
  return sum(x.pieces[pos].numel() * x.pieces[pos].element_size()
             for x in _leaves(sharded))


@dataclasses.dataclass
class ShardedState:
  """A train state on a mesh: the f32 master and AdamW's moments under the
  parameters' specs (``specs_like``'s tree), and the step count (int32,
  on the mesh's first device)."""

  mesh: object
  specs: dict
  master: dict
  m: dict
  v: dict
  step: Tensor

  def gathered(self, device="cpu") -> dict:
    """{'params', 'opt': {'m', 'v', 'step'}} as whole tensors on
    ``device``: the tree a checkpoint stores."""
    return {"params": gather_tree(self.master, device),
            "opt": {"m": gather_tree(self.m, device),
                    "v": gather_tree(self.v, device),
                    "step": self.step.to(device)}}

  def local_bytes(self, pos: tuple) -> int:
    """Bytes position ``pos`` holds over the master and both moments."""
    return sum(tree_local_bytes(t, pos) for t in (self.master, self.m,
                                                  self.v))


def shard_state(params, specs, mesh, opt_state: Optional[dict] = None
                ) -> ShardedState:
  """A ``ShardedState`` of ``params`` (a ``zoo.param_tree``, whole, on any
  device) cut by ``specs`` onto ``mesh``; the moments and step from
  ``opt_state`` (``init_opt_state``'s layout), or zero."""
  master = shard_tree(params, specs, mesh, torch.float32)
  dev0 = mesh.devices[0][0]
  if opt_state is None:
    def zeros(x):
      return Sharded(x.shape, torch.float32, x.spec, mesh,
                     {pos: torch.zeros_like(p) for pos, p in x.pieces.items()})
    m, v = tree_map(zeros, master), tree_map(zeros, master)
    step = torch.zeros((), dtype=torch.int32, device=dev0)
  else:
    m = shard_tree(opt_state["m"], specs, mesh, torch.float32)
    v = shard_tree(opt_state["v"], specs, mesh, torch.float32)
    step = torch.as_tensor(opt_state["step"]).to(dev0, torch.int32,
                                                 copy=True)
  return ShardedState(mesh, specs, master, m, v, step)
