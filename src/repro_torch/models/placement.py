"""Where a spec puts each piece of a leaf on a mesh.

Port-only: the counterpart of the reference's ``NamedSharding`` /
``jax.device_put``, on the single-controller ``launch.mesh.Mesh``.  Both
tensor-parallel serving (``zoo.ShardedLM``) and training on a mesh
(``train/sharded.py``) place their tensors with it.

A spec is a plain tuple with one entry per dimension, as
``common.specs_like`` gives it: an axis name, a tuple of names or ``None``.
A leaf is cut dimension by dimension: the positions along the axes an
entry names (the first name major) pick a piece of ceil(dim / their sizes'
product) rows, the last one shorter — the size ``launch/dryrun.local_bytes``
reckons.  Every mesh position holds its own piece on its own device;
positions that differ only along an axis the spec does not name hold real
copies of the same piece (replicas).

In training, ``gather_part`` is the gather along ``data`` with a
backward: the part is copied together from the pieces by a ``fetch``
callable (``assemble`` bound to the part, no gradient recorded on the
pieces), and its backward hands the part's gradient to a callback that
adds it into the owners' gradient sums (``train/sharded.PositionGrads``).
Nothing keeps the gathered part alive but the tensors the forward saves
from it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

Tensor = torch.Tensor


def names(entry) -> tuple:
  """The axis names one spec entry cuts a dimension over."""
  if entry is None:
    return ()
  return entry if isinstance(entry, tuple) else (entry,)


def positions(mesh) -> list:
  """Every (row, col) position of ``mesh``, row by row."""
  rows, cols = len(mesh.devices), len(mesh.devices[0])
  return [(i, j) for i in range(rows) for j in range(cols)]


def piece_box(shape, spec, mesh, pos: tuple) -> tuple:
  """The slices of a ``shape``-d leaf that position ``pos`` holds under
  ``spec``."""
  if len(spec) != len(shape):
    raise ValueError(f"spec {spec} for a {len(shape)}-dimensional leaf")
  sizes, at = mesh.shape, dict(zip(mesh.axis_names, pos))
  box = []
  for dim, entry in zip(shape, spec):
    axes = names(entry)
    for a in axes:
      if a not in sizes:
        raise ValueError(f"spec {spec} names axis {a!r}, not one of the "
                         f"mesh's {tuple(sizes)}")
    factor = math.prod(sizes[a] for a in axes)
    idx = 0
    for a in axes:
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


def map2(fn, tree, specs):
  """``fn(leaf, spec)`` over a tree and its spec tree, walked together."""
  if isinstance(tree, dict):
    return {k: map2(fn, v, specs[k]) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [map2(fn, v, s) for v, s in zip(tree, specs, strict=True)]
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
  return map2(lambda t, s: shard_leaf(t, s, mesh, dtype), tree, specs)


def assemble(box: tuple, sources, device, dtype: torch.dtype) -> Tensor:
  """The part ``box`` (slices of a whole leaf) on ``device`` in ``dtype``,
  copied together from ``sources``, (box, piece) pairs whose boxes do not
  overlap and cover it: the all-gather of a whole leaf, or tensor-parallel
  serving's per-layer gather along ``data``."""
  device = torch.device(device)
  out = torch.empty([s.stop - s.start for s in box], dtype=dtype,
                    device=device)
  with torch.no_grad():
    for src_box, piece in sources:
      cut = [slice(max(a.start, b.start), min(a.stop, b.stop))
             for a, b in zip(box, src_box)]
      if any(c.start >= c.stop for c in cut):
        continue
      out[tuple(slice(c.start - a.start, c.stop - a.start)
                for c, a in zip(cut, box))].copy_(
          piece[tuple(slice(c.start - b.start, c.stop - b.start)
                      for c, b in zip(cut, src_box))],
          non_blocking=device.type == "cuda")
  return out


class _Gathered(torch.autograd.Function):
  """``fetch()`` as a node of the autograd graph: the ``anchor`` (an empty
  leaf that wants a gradient) puts it there, and the backward gives the
  part's gradient to ``route`` instead of to any input."""

  @staticmethod
  def forward(ctx, anchor, fetch, route):
    ctx.route = route
    return fetch()

  @staticmethod
  def backward(ctx, grad):
    ctx.route(grad)
    return (None,) * 3


def gather_part(fetch, route) -> Tensor:
  """The part ``fetch()`` copies together (``assemble`` bound to a box,
  its sources, a device and a dtype) as a part of the autograd graph:
  ``route(grad)`` receives its gradient (once per use of the part) during
  the backward."""
  anchor = torch.empty(0, requires_grad=True)
  return _Gathered.apply(anchor, fetch, route)
