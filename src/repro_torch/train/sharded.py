"""Training state cut over a mesh: placement, the all-gather and the
reduce-scatter of the train step.

Port-only: it takes the place of the reference's ``NamedSharding`` /
``jax.device_put`` placement plus GSPMD (``repro/launch/train.py``,
``repro/train/steps.py``), on the single-controller ``launch.mesh.Mesh``
that ``core/distributed.py`` and ``models/pipeline.py`` use.  One process
holds every shard's tensors on the shard's device and moves them with peer
copies.

A spec is a plain tuple with one entry per dimension, as
``models/common.specs_like`` gives it: an axis name, a tuple of names or
``None``.  A leaf is cut dimension by dimension: the positions along the
axes an entry names (the first name major) pick a piece of ceil(dim /
their sizes' product) rows, the last one shorter — the size
``launch/dryrun.local_bytes`` reckons.  Every mesh position holds its own
piece on its own device; positions that differ only along an axis the spec
does not name hold real copies of the same piece (replicas), which the
step keeps equal by computing each one in the same order.

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
import math
from typing import Optional

import torch

from repro_torch.train.optimizer import _leaves, tree_map

Tensor = torch.Tensor


def _names(entry) -> tuple:
  if entry is None:
    return ()
  return entry if isinstance(entry, tuple) else (entry,)


def _coords(mesh, pos: tuple) -> dict:
  return dict(zip(mesh.axis_names, pos))


def positions(mesh) -> list:
  """Every (row, col) position of ``mesh``, row by row."""
  rows, cols = len(mesh.devices), len(mesh.devices[0])
  return [(i, j) for i in range(rows) for j in range(cols)]


def piece_box(shape, spec, mesh, pos: tuple) -> tuple:
  """The slices of a ``shape``-d leaf that position ``pos`` holds under
  ``spec``."""
  if len(spec) != len(shape):
    raise ValueError(f"spec {spec} for a {len(shape)}-dimensional leaf")
  sizes, at = mesh.shape, _coords(mesh, pos)
  box = []
  for dim, entry in zip(shape, spec):
    names = _names(entry)
    for a in names:
      if a not in sizes:
        raise ValueError(f"spec {spec} names axis {a!r}, not one of the "
                         f"mesh's {tuple(sizes)}")
    factor = math.prod(sizes[a] for a in names)
    idx = 0
    for a in names:
      idx = idx * sizes[a] + at[a]
    chunk = -(-dim // factor)
    start = min(dim, idx * chunk)
    box.append(slice(start, min(dim, start + chunk)))
  return tuple(box)


@dataclasses.dataclass
class Sharded:
  """One leaf on a mesh: its whole shape and dtype, its spec, and the piece
  each position holds (``pieces[(i, j)]`` on ``mesh.devices[i][j]``)."""

  shape: torch.Size
  dtype: torch.dtype
  spec: tuple
  mesh: object
  pieces: dict
  boxes: dict = dataclasses.field(init=False, repr=False)

  def __post_init__(self):
    self.boxes = {pos: piece_box(self.shape, self.spec, self.mesh, pos)
                  for pos in positions(self.mesh)}

  def box(self, pos: tuple) -> tuple:
    return self.boxes[pos]

  def owners(self) -> dict:
    """box → the positions holding it (replicas share a box), in position
    order."""
    out: dict = {}
    for pos, box in self.boxes.items():
      out.setdefault(tuple((s.start, s.stop) for s in box), []).append(pos)
    return out

  def distinct(self) -> list:
    """One position per distinct box: each element is held by exactly one
    of them."""
    return [ps[0] for ps in self.owners().values()]


def _map2(fn, tree, specs):
  """``fn(leaf, spec)`` over a tree and its spec tree, walked together."""
  if isinstance(tree, dict):
    return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_map2(fn, v, s) for v, s in zip(tree, specs, strict=True)]
  return fn(tree, specs)


def shard_leaf(t: Tensor, spec, mesh, dtype: Optional[torch.dtype] = None
               ) -> Sharded:
  """``t`` cut by ``spec``: each position's piece copied onto its device
  (a copy even where the device is ``t``'s)."""
  dtype = dtype or t.dtype
  pieces = {}
  with torch.no_grad():
    for pos in positions(mesh):
      dev = mesh.devices[pos[0]][pos[1]]
      pieces[pos] = t[piece_box(t.shape, spec, mesh, pos)].to(
          device=dev, dtype=dtype, copy=True).contiguous()
  return Sharded(t.shape, dtype, tuple(spec), mesh, pieces)


def shard_tree(tree, specs, mesh, dtype: Optional[torch.dtype] = None):
  """Each leaf of ``tree`` cut by its spec onto ``mesh`` (a tree of
  ``Sharded`` leaves)."""
  return _map2(lambda t, s: shard_leaf(t, s, mesh, dtype), tree, specs)


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
  out = torch.empty(x.shape, dtype=dtype, device=device)
  with torch.no_grad():
    for pos in x.distinct():
      out[x.box(pos)].copy_(x.pieces[pos],
                            non_blocking=device.type == "cuda")
  return out


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
