"""Three-term roofline of one dry-run cell on H100s.

Counterpart of ``repro/roofline/analysis.py``, with the card's rates
(``roofline/hw.py``) in place of the TPU's:

    compute    = FLOPs / (chips · PEAK_OPS["bfloat16"])      989e12 each
    memory     = bytes / (chips · PEAK_BYTES_S)              3.35e12 each
    collective = Σ_axis coll_bytes[axis] / link_rate(axis)

FLOPs and bytes are the global program's (``roofline/flops.py`` counts
them at dispatch); collective bytes are per device, per mesh axis group,
from the ring model (``collectives.ring_traffic_bytes``).  An axis group
whose devices lie within one host of ``hw.CARDS_PER_HOST`` cards runs at
NVLink's one-way rate (``hw.NVLINK_BYTES_S``); one that spans hosts at
the host's network rate per card (``hw.INTERHOST_BYTES_S``).  Without a
per-axis split, collective bytes are charged at the inter-host rate.
MODEL_FLOPS uses the 6·N·D (train) / 2·N·D (prefill, decode-token)
convention with N = active params.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.roofline import hw


def axis_group_rate(mesh, axes) -> float:
  """Link rate of a collective over ``axes`` of ``mesh`` (an
  ``AbstractMesh`` or ``Mesh``: the last axis varies fastest over cards
  numbered host by host).  The group of an axis of stride s and size n
  lies in an aligned block of s·n cards; the group lies within one host
  when that block divides ``hw.CARDS_PER_HOST``."""
  axes = (axes,) if isinstance(axes, str) else tuple(axes)
  names = list(mesh.shape)
  sizes = [mesh.shape[a] for a in names]
  block = max(math.prod(sizes[names.index(a):]) for a in axes)
  within = hw.CARDS_PER_HOST % block == 0
  return hw.NVLINK_BYTES_S if within else hw.INTERHOST_BYTES_S


@dataclasses.dataclass
class Roofline:
  arch: str
  shape: str
  mesh: str
  chips: int
  hlo_flops: float
  hlo_bytes: float
  coll_bytes: float          # per device
  coll_breakdown: dict
  model_flops: float
  peak_memory_per_dev: Optional[float] = None
  # per device collective bytes by axis group, and each group's link rate
  coll_axis_bytes: Optional[dict] = None
  axis_rates: Optional[dict] = None

  @property
  def t_compute(self) -> float:
    return self.hlo_flops / (self.chips * hw.PEAK_OPS["bfloat16"])

  @property
  def t_memory(self) -> float:
    return self.hlo_bytes / (self.chips * hw.PEAK_BYTES_S)

  @property
  def t_collective(self) -> float:
    if self.coll_axis_bytes is None:
      return self.coll_bytes / hw.INTERHOST_BYTES_S
    return sum(b / self.axis_rates[ax]
               for ax, b in self.coll_axis_bytes.items())

  @property
  def bottleneck(self) -> str:
    terms = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
    return max(terms, key=terms.get)

  @property
  def t_bound(self) -> float:
    return max(self.t_compute, self.t_memory, self.t_collective)

  @property
  def useful_ratio(self) -> float:
    """MODEL_FLOPS / counted FLOPs — how much counted compute is
    'useful'."""
    return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

  @property
  def mfu_bound(self) -> float:
    """Roofline-implied MFU upper bound: useful FLOPs per chip-second at
    the bound time vs peak."""
    if self.t_bound == 0:
      return 0.0
    return (self.model_flops / (self.chips * self.t_bound)) / \
        hw.PEAK_OPS["bfloat16"]

  def row(self) -> dict:
    return {
        "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
        "chips": self.chips,
        "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
        "coll_bytes_per_dev": self.coll_bytes,
        "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
        "t_collective_s": self.t_collective,
        "bottleneck": self.bottleneck,
        "model_flops": self.model_flops,
        "useful_ratio": self.useful_ratio,
        "mfu_bound": self.mfu_bound,
        "peak_mem_per_dev": self.peak_memory_per_dev,
        "coll_breakdown": self.coll_breakdown,
    }


def model_flops_estimate(n_params_active: float, shape_kind: str,
                         tokens: float) -> float:
  """6·N·D for a train step; 2·N per generated token for decode; 2·N·D for
  prefill (forward only)."""
  if shape_kind == "train":
    return 6.0 * n_params_active * tokens
  return 2.0 * n_params_active * tokens
