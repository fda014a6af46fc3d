"""Training state cut over a mesh: the all-gather and the reduce-scatter
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
  * ``reduce_scatter`` — one data line's gradients into the owners' pieces,
    summed in f32 (rounded to bf16 for the copy when asked);
  * ``ShardedState`` — the f32 master and AdamW's ``m`` and ``v`` under the
    parameters' specs, and the replicated step count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.placement import (Sharded, assemble, positions,
                                          shard_leaf, shard_tree)
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


def reduce_scatter(acc, grads: list, bf16: bool = False):
  """Add one line's whole f32 gradients (``grads``, in ``_leaves`` order)
  into ``acc``, a tree of ``Sharded`` f32 sums: each position takes its
  box, copied onto its device (rounded to bf16 for the copy when ``bf16``)
  and summed in f32.  A position with nothing summed yet (a piece of
  ``None``) takes the copy itself."""
  for x, g in zip(_leaves(acc), grads, strict=True):
    for pos in positions(x.mesh):
      dev = x.mesh.devices[pos[0]][pos[1]]
      part = g[x.box(pos)]
      if bf16:
        part = part.to(torch.bfloat16)
      if x.pieces[pos] is None:  # a copy: replicas must not share storage
        x.pieces[pos] = part.to(dev, torch.float32, copy=True).contiguous()
      else:
        x.pieces[pos].add_(part.to(dev, non_blocking=True))
  return acc


def empty_like_tree(sharded):
  """A tree of ``Sharded`` f32 sums with no pieces yet, for
  ``reduce_scatter``."""
  return tree_map(lambda x: Sharded(x.shape, torch.float32, x.spec, x.mesh,
                                    {pos: None for pos in positions(x.mesh)}),
                  sharded)


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
