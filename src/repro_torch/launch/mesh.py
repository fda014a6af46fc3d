"""Device meshes for the single-controller distributed schedules.

Counterpart of ``repro/launch/mesh.py``'s ``make_host_mesh``.  The
reference's mesh is a ``jax.sharding.Mesh`` that one process
``shard_map``s over; the port keeps that single-controller design: one
Python process issues every shard's work onto the devices of a ``Mesh``,
and its collectives are peer copies (``Tensor.to(device)``) and
⊕-reductions (``core/distributed.py``).  The same code then runs on 8 CPU
shards in the tests, on shards of one card and on several cards joined by
NVLink.

A mesh whose shards share a device is built only from an explicit
``devices=`` list: nothing picks one on its own.

The production layout (``make_production_mesh``, ``make_parallelism``) is
the reference's: single pod (data 16, model 16) = 256 chips, multi-pod
(pod 2, data 16, model 16) = 512, the batch sharded over (pod, data).  The
dry run (``launch/dryrun.py``) reads it without the machines, so it is an
``AbstractMesh``: axis names and sizes with no devices, as
``jax.sharding.AbstractMesh`` is.  A runnable ``Mesh`` stays two-dimensional.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.models.common import Parallelism

AXIS_NAMES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
  """An immutable (rows, cols) grid of ``torch.device``s with axis names.

  ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
  does; ``size`` is the number of shards.  Hashable, so a mesh can key the
  serving engine's executable cache.  Shard (i, j) is ``devices[i][j]``;
  ``flat`` lists them row by row.
  """

  devices: tuple
  axis_names: tuple = AXIS_NAMES

  def __post_init__(self):
    grid = tuple(tuple(torch.device(d) for d in row) for row in self.devices)
    names = tuple(str(a) for a in self.axis_names)
    if len(names) != 2 or len(set(names)) != 2:
      raise ValueError(
          f"a mesh has two distinct axis names, got {names}; a layout of "
          f"other axes with no devices behind it is an AbstractMesh")
    if not grid or not grid[0] or len({len(row) for row in grid}) != 1:
      raise ValueError("mesh devices must form a non-empty (rows, cols) grid")
    kinds = {d.type for row in grid for d in row}
    if len(kinds) != 1:
      raise ValueError(f"a mesh holds devices of one type, got {sorted(kinds)}")
    object.__setattr__(self, "devices", grid)
    object.__setattr__(self, "axis_names", names)

  @property
  def shape(self) -> dict:
    return {self.axis_names[0]: len(self.devices),
            self.axis_names[1]: len(self.devices[0])}

  @property
  def size(self) -> int:
    return len(self.devices) * len(self.devices[0])

  @property
  def flat(self) -> tuple:
    return tuple(d for row in self.devices for d in row)

  @property
  def device_type(self) -> str:
    return self.devices[0][0].type


def available_devices(device: str) -> list:
  """Every device of ``device``'s type this process can use: the cards
  present, or the one CPU."""
  kind = torch.device(device).type
  if kind == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("a CUDA mesh was requested but "
                         "torch.cuda.is_available() is false")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
  if kind == "cpu":
    return [torch.device("cpu")]
  raise ValueError(f"no mesh over devices of type {kind!r}")


def make_host_mesh(n_devices: int = 0, model: int = 2, *,
                   device: str = "cuda",
                   devices: Sequence | None = None,
                   axis_names: Sequence = AXIS_NAMES) -> Mesh:
  """A (n // model, model) mesh over ``n_devices`` devices (0: all), its
  axes named ``axis_names`` (e.g. ("stage", "data") for the pipeline).

  Without ``devices`` it takes the devices of ``device``'s type that exist
  (``cuda``: the cards present) and raises when fewer exist than asked
  for.  ``devices`` names the shards outright, repeats allowed: e.g.
  ``["cpu"] * 8`` in the tests, or ``["cuda:0"] * 4`` for a virtual mesh
  of four shards of one card.
  """
  pool = (available_devices(device) if devices is None
          else [torch.device(d) for d in devices])
  n = n_devices or len(pool)
  if n > len(pool):
    raise ValueError(f"a mesh of {n} devices was asked for, but only "
                     f"{len(pool)} exist")
  model = min(model, n)
  if model < 1 or n % model:
    raise ValueError(f"{n} devices do not split into rows of {model}")
  pool = pool[:n]
  return Mesh(tuple(tuple(pool[r * model:(r + 1) * model])
                    for r in range(n // model)), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
  """Axis names and sizes with no devices: ``shape`` maps each name to its
  size (in axis order), ``size`` is the number of chips."""

  axis_sizes: tuple
  axis_names: tuple

  def __post_init__(self):
    sizes = tuple(int(n) for n in self.axis_sizes)
    names = tuple(str(a) for a in self.axis_names)
    if len(sizes) != len(names) or len(set(names)) != len(names):
      raise ValueError(f"one distinct name per axis, got {names} for "
                       f"{sizes}")
    if not sizes or min(sizes) < 1:
      raise ValueError(f"axis sizes must be positive, got {sizes}")
    object.__setattr__(self, "axis_sizes", sizes)
    object.__setattr__(self, "axis_names", names)

  @property
  def shape(self) -> dict:
    return dict(zip(self.axis_names, self.axis_sizes))

  @property
  def size(self) -> int:
    return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
  """The production layout as an ``AbstractMesh``."""
  if multi_pod:
    return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
  return AbstractMesh((16, 16), ("data", "model"))


def as_abstract_mesh(mesh) -> tuple:
  """(AbstractMesh, label) of "single", "multi" (the production layouts)
  or an ``AbstractMesh`` (labelled by its sizes, e.g. "2x2")."""
  if isinstance(mesh, AbstractMesh):
    return mesh, "x".join(map(str, mesh.axis_sizes))
  if mesh not in ("single", "multi"):
    raise ValueError(f"mesh must be 'single', 'multi' or an AbstractMesh, "
                     f"got {mesh!r}")
  return make_production_mesh(multi_pod=mesh == "multi"), mesh


def make_parallelism(*, multi_pod: bool = False, fsdp: bool = True,
                     seq_shard_decode: bool = True,
                     remat: str = "none") -> Parallelism:
  return Parallelism(
      data_axes=("pod", "data") if multi_pod else ("data",),
      model_axis="model",
      tp_size=16,
      dp_size=32 if multi_pod else 16,
      fsdp=fsdp,
      seq_shard_decode=seq_shard_decode,
      remat=remat,
  )
