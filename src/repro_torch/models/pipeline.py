"""Pipeline parallelism: the GPipe schedule on the port's device mesh.

Counterpart of ``repro/models/pipeline.py``.  The layer stack is split
into S stages along the mesh's ``stage`` axis; M microbatches flow through
them, T = M + S − 1 ticks in all (bubble fraction (S − 1)/T).  The
reference ``shard_map``s one SPMD program over the mesh with one
``ppermute`` per tick.  The port keeps the single-controller design of
``core/distributed.py``: one process issues every shard's work onto the
devices of a ``launch.mesh.Mesh``.

  * stage s owns its parameter slice, copied to the devices of line s
    along ``axis`` (no copy where the device already holds it);
  * on each tick every stage applies ``stage_fn`` to its buffer, and each
    output is copied to the next stage's device (the copy takes the place
    of the ppermute); stage 0 injects microbatch t, zeros once t ≥ M;
  * the last stage's outputs are collected on the input's device;
  * ``x_spec=(None, other_axis)`` shards each microbatch's rows over the
    mesh's other axis, as the reference's ``P(None, "data")`` does; with
    the default (replicated) x, every line along the other axis would
    compute the same rows, so only the first is issued.

Autograd runs through the device copies, so one function serves the
forward and training, as in the reference.  No work waits on the host: a
shard's whole schedule is issued before anything is read back.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree)


def split_stages(stacked_params, n_stages: int):
  """(L, …) stacked layer params → (S, L/S, …) views."""
  def re(t):
    n = t.shape[0]
    if n % n_stages:
      raise ValueError(f"{n} layers do not split into {n_stages} stages")
    return t.reshape(n_stages, n // n_stages, *t.shape[1:])
  return _tree_map(re, stacked_params)


def _spec(spec, default: tuple) -> tuple:
  return default if spec is None else tuple(spec)


def pipeline(stage_fn: Callable, mesh, *, axis: str = "stage",
             in_spec: Optional[tuple] = None,
             x_spec: Optional[tuple] = None):
  """Build pipelined_apply(stage_params, x_micro) → y_micro.

  stage_fn(params_one_stage, x) → y of x's shape (e.g. a loop over the
  stage's layer slice).  stage_params: a tree of (S, L/S, …) tensors, S =
  ``mesh.shape[axis]``; x_micro: (M, mb, …).  The specs name mesh axes per
  dimension as the reference's ``PartitionSpec``s do, as tuples: the
  params are sharded on their leading dim along ``axis`` (``in_spec``
  ``(axis,)``, the only layout), and x is replicated (``()``, the
  default) or has its rows sharded along the other axis (``(None,
  other)``).  The result is on x's device.
  """
  if axis not in mesh.axis_names:
    raise ValueError(f"the mesh has no axis {axis!r}; its axes are "
                     f"{mesh.axis_names}")
  pos = mesh.axis_names.index(axis)
  other = mesh.axis_names[1 - pos]
  if _spec(in_spec, (axis,)) != (axis,):
    raise ValueError(f"in_spec must shard the stage dim along {axis!r}, "
                     f"got {in_spec!r}")
  xs = _spec(x_spec, ())
  if xs not in ((), (None,), (None, other)):
    raise ValueError(f"x_spec is () or (None, {other!r}), got {x_spec!r}")
  n_stage = mesh.shape[axis]
  n_rows = mesh.shape[other] if xs == (None, other) else 1

  def device(stage: int, line: int) -> torch.device:
    return (mesh.devices[stage][line] if pos == 0
            else mesh.devices[line][stage])

  def pipelined_apply(stage_params, x_micro: Tensor) -> Tensor:
    leaves = []
    _tree_map(leaves.append, stage_params)
    if any(t.shape[0] != n_stage for t in leaves):
      raise ValueError(f"stage params must lead with {n_stage} stages, got "
                       f"{[tuple(t.shape) for t in leaves]}")
    m, mb = x_micro.shape[:2]
    if mb % n_rows:
      raise ValueError(f"{mb} rows per microbatch do not split over "
                       f"{n_rows} shards of {other!r}")
    rows = mb // n_rows
    parts = []
    for line in range(n_rows):
      params = [_tree_map(lambda t, s=s: t[s].to(device(s, line)),
                          stage_params) for s in range(n_stage)]
      xs_line = x_micro[:, line * rows:(line + 1) * rows].to(device(0, line))
      bufs = [torch.zeros_like(xs_line[0], device=device(s, line))
              for s in range(n_stage)]
      outs = [None] * m
      for t in range(m + n_stage - 1):
        inject = xs_line[t] if t < m else torch.zeros_like(xs_line[0])
        nxt = [None] * n_stage
        for s in range(n_stage):
          y = stage_fn(params[s], inject if s == 0 else bufs[s])
          if s + 1 < n_stage:
            nxt[s + 1] = y.to(device(s + 1, line))
          elif t >= n_stage - 1:      # the last stage emits t − (S − 1)
            outs[t - (n_stage - 1)] = y.to(x_micro.device)
        bufs = nxt
      parts.append(torch.stack(outs))
    return torch.cat(parts, dim=1)

  return pipelined_apply


def bubble_fraction(n_stages: int, n_micro: int) -> float:
  return (n_stages - 1) / (n_micro + n_stages - 1)
