"""Versioned JSON cost table with an analytic roofline prior for the H100.

Counterpart of ``repro/tuning/cost_table.py``.  One entry per *point* —
(op, contraction shape bucket, dtype, backend, block config) — holding the
best-of seconds measured on the live device, or a roofline estimate for
points nobody has measured yet.  A
measured entry always beats a prior at the same point (``record`` enforces
the precedence); across points, ``best`` is a plain argmin over seconds.

The key is the **bucket signature**, not the raw shape: the serving
scheduler pads every problem up to its power-of-two bucket, so two raw
shapes in one bucket run the same executable and share one decision.  The
signature strings are the reference's, so a table either package wrote
loads in the other.

The prior is the port's own (the reference's is a TPU v5e model).  Per arm,
on the bucketed (m, k, n), it is the larger of the bytes the contraction
moves at ``hw.PEAK_BYTES_S`` and its compute term (``roofline/hw.py``):

  pallas      K1: mma at 3×TF32 on the tensor cores; every other ring,
              orand included, on the CUDA cores at two instructions per
              term; plus one launch (``hw.LAUNCH_OVERHEAD_S``), so tiny
              buckets do not prefer a kernel launch on the prior alone;
  megakernel  K2 (and the arena's tick, ``arena``): K1's compute term with
              the bytes over G, since the iterate stays on the card for the
              G fused steps of one launch, and the launch over G too;
  xla         rings with a matmul rewrite (mma, addnorm, orand) at the f32
              CUDA-core FMA rate (``torch.matmul`` with TF32 off); the rest
              as ``vector``;
  vector      the blocked broadcast-reduce: two CUDA-core instructions per
              term, and bytes that include writing and reading the
              (m, bk, n) ⊗ intermediate of every K block and the running
              ⊕ of each block.

Mesh rows (``SCHEDULE_ARMS``) hold one distributed schedule's seconds per
request on a (rows, cols) mesh: the backend column is the schedule and the
cfg column the mesh shape (``...|summa|2x2``), as in the reference's
tables.  Their prior (``sharded_prior_seconds``) is the per-shard local
prior above plus the ring-model traffic (``roofline/collectives.py``) at
the NVLink rate, plus ``DP_OVERHEAD_S``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.roofline import hw

__all__ = ["SCHEMA_VERSION", "MIN_BUCKET", "DEFAULT_CONFIGS",
           "CLOSURE_BACKENDS", "SCHEDULE_ARMS", "DP_OVERHEAD_S", "Decision",
           "CostEntry", "CostTable", "bucket_dim", "bucket_shape",
           "dtype_name", "signature", "prior_seconds",
           "sharded_prior_seconds"]

SCHEMA_VERSION = 1

MIN_BUCKET = 8  # canonical bucket floor; serve_mmo.scheduler re-exports it

# Candidate block configs swept per backend: 'vector'/'xla' tune the K block
# of the blocked broadcast-reduce (ignored by the matmul rewrites),
# 'megakernel' tunes the fused chunk length G.  K1 chooses its tile inside
# the kernel by its shape rule (kernels/semiring_mmo.py), so 'pallas' has
# the one empty config.
DEFAULT_CONFIGS = {
    "vector": ((128,), (512,)),
    "xla": ((512,),),
    "pallas": ((),),
    "megakernel": ((2,), (4,), (8,)),
}

# The backend pool closure buckets dispatch over: the per-contraction arms
# plus the fused whole-fixpoint arm K2.  ``best``'s default order leaves
# 'megakernel' out: a single mmo call cannot run a fused fixpoint, so only
# callers that own a whole closure loop pass this pool.
CLOSURE_BACKENDS = ("xla", "vector", "pallas", "megakernel")


def bucket_dim(n: int, min_bucket: int = MIN_BUCKET) -> int:
  """Round ``n`` up to the next power of two, with a floor."""
  if n <= 0:
    raise ValueError(f"dimension must be positive, got {n}")
  b = min_bucket
  while b < n:
    b *= 2
  return b


def bucket_shape(shape: tuple, min_bucket: int = MIN_BUCKET) -> tuple:
  return tuple(bucket_dim(int(d), min_bucket) for d in shape)


def dtype_name(dtype) -> str:
  """One spelling for numpy, string and torch dtypes ('float32', 'bool',
  'bfloat16'), the one the signatures use."""
  if isinstance(dtype, torch.dtype):
    return str(dtype).removeprefix("torch.")
  if dtype == "bfloat16":  # numpy has no bfloat16 of its own
    return "bfloat16"
  return str(np.dtype(dtype))


def signature(op: str, shape: Sequence[int], dtype, backend: str,
              cfg: tuple = ()) -> str:
  """Canonical string key for one table point; ``shape`` is (M, K, N) and is
  bucketed here, so raw and pre-bucketed shapes collide onto one entry."""
  m, k, n = bucket_shape(tuple(shape))
  cfg_s = "x".join(str(int(c)) for c in cfg) if cfg else "-"
  return (f"{sr_mod.get(op).name}|{m}x{k}x{n}|{dtype_name(dtype)}|{backend}|"
          f"{cfg_s}")


def _parse_cfg(cfg_s: str) -> tuple:
  return () if cfg_s == "-" else tuple(int(c) for c in cfg_s.split("x"))


class Decision(NamedTuple):
  """One dispatch outcome: which backend runs the bucket, with which blocks."""
  backend: str
  cfg: tuple
  seconds: float
  source: str  # 'measured' | 'prior' | 'default'


@dataclasses.dataclass
class CostEntry:
  seconds: float
  source: str  # 'measured' | 'prior'


def _itemsize(dtype) -> int:
  return getattr(torch, dtype_name(dtype)).itemsize


# Distributed-schedule arms the table can hold rows for
# (core.distributed's batched schedules); their cfg column is the mesh shape.
SCHEDULE_ARMS = ("dp", "kspan", "summa", "ring")

# Host seconds one sharded call costs beyond the shards' own kernels: the
# controller issues every shard's launches and peer copies, one after
# another.  Charged to every schedule arm (dp moves no bytes, so without it
# the model would shard contractions too small to pay for their launches).
# Measured by chip_smoke.py (phase 9a: a 4 × 8³ minplus batch on dp over a
# 2 × 2 mesh of one card's shards, 0.2119 ms per call, against one local
# K1 launch on it, 0.0248 ms; 500 calls each between two CUDA events) on an
# NVIDIA H100 80GB HBM3 at 700 W: 0.1872 ms.
DP_OVERHEAD_S = 1.872e-4


def _local_point_seconds(sr, m: int, k: int, n: int, name: str,
                         backend: str, cfg: tuple) -> float:
  """The prior of one (m, k, n) contraction on one device, unbucketed:
  ``prior_seconds``' model, and the per-shard term of
  ``sharded_prior_seconds``."""
  terms = float(m) * k * n
  t_mem = (_itemsize(name) * (m * k + k * n) + 4 * m * n) / hw.PEAK_BYTES_S
  if backend in ("pallas", "megakernel", "arena"):
    t_comp = (hw.ops_seconds("mma", name, terms) if sr.name == "mma"
              else hw.cuda_core_seconds(terms))
    if backend == "pallas":
      return max(t_comp, t_mem) + hw.LAUNCH_OVERHEAD_S
    g = max(int(cfg[0]) if cfg else 8, 1)
    return max(t_comp, t_mem / g) + hw.LAUNCH_OVERHEAD_S / g
  if backend == "xla" and sr.mxu_rewrite is not None:
    return max(2.0 * terms / hw.PEAK_OPS["float32"], t_mem)
  if backend not in ("xla", "vector"):
    raise ValueError(f"no prior for backend {backend!r}")
  block_k = max(1, min(int(cfg[0]) if cfg else 512, k))
  blocks = math.ceil(k / block_k)
  # the ⊗ intermediate, written then read, over all blocks; each block's
  # ⊕ into the running result reads two (m, n) tiles and writes one
  t_mem += (2 * 4 * terms + 3 * 4 * m * n * blocks) / hw.PEAK_BYTES_S
  return max(hw.cuda_core_seconds(terms), t_mem)


def prior_seconds(op: str, shape: Sequence[int], dtype, backend: str,
                  cfg: tuple = ()) -> float:
  """Analytic roofline prior for one point on the H100 (seconds); see the
  module docstring for the model of each arm."""
  m, k, n = bucket_shape(tuple(shape))
  return _local_point_seconds(sr_mod.get(op), m, k, n, dtype_name(dtype),
                              backend, cfg)


def sharded_prior_seconds(op: str, shape: Sequence[int], dtype,
                          schedule: str, mesh_shape: Sequence[int], *,
                          backend: str = "xla") -> float:
  """Analytic prior for one distributed schedule on a (rows, cols) mesh,
  seconds per request: the per-shard local prior on ``backend`` plus the
  ring-model traffic of its collectives at ``hw.NVLINK_BYTES_S``, plus
  ``DP_OVERHEAD_S``.  The model ``dispatch.resolve`` compares against the
  local prior when the table holds no measured mesh row."""
  from repro_torch.roofline.collectives import ring_traffic_bytes
  sr = sr_mod.get(op)
  m, k, n = bucket_shape(tuple(shape))
  dims = tuple(int(d) for d in mesh_shape)
  rows, cols = max(dims[0], 1), max(dims[-1], 1)
  name = dtype_name(dtype)
  itemsize = _itemsize(name)

  def local(mm, kk, nn):
    return _local_point_seconds(sr, max(mm, 1), max(kk, 1), max(nn, 1),
                                name, backend, ())

  if schedule == "dp":
    # every shard contracts whole requests: one request's share of a batch
    # sharded over all of them, with no collective
    return local(m, k, n) / math.prod(max(d, 1) for d in dims) + DP_OVERHEAD_S
  if schedule == "kspan":
    t = local(m, k // cols, n)
    coll = ring_traffic_bytes("all-reduce", 4.0 * m * n, cols)
  elif schedule == "summa":
    t = local(m // rows, k, n // cols)
    coll = (ring_traffic_bytes("all-gather", itemsize * (m // rows) * k, cols)
            + ring_traffic_bytes("all-gather", itemsize * k * (n // cols),
                                 rows))
  elif schedule == "ring":
    t = cols * local(m, k // cols, n // cols)
    coll = cols * ring_traffic_bytes("collective-permute",
                                     itemsize * (k // cols) * n, cols)
  else:
    raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULE_ARMS}")
  return t + coll / hw.NVLINK_BYTES_S + DP_OVERHEAD_S


class CostTable:
  """In-memory cost table with JSON (de)serialization."""

  def __init__(self, *, device: str = "unknown"):
    self.version = SCHEMA_VERSION
    self.device = device
    self.entries: dict[str, CostEntry] = {}
    self._best_cache: dict = {}  # memoized best(), cleared on record()

  def __len__(self) -> int:
    return len(self.entries)

  # -- writes ----------------------------------------------------------------

  def record(self, op: str, shape, dtype, backend: str, cfg: tuple,
             seconds: float, *, source: str = "measured") -> bool:
    """Insert one point.  A prior never overwrites a measurement; a
    measurement overwrites anything.  Returns whether the entry was stored."""
    if source not in ("measured", "prior"):
      raise ValueError(f"source must be 'measured' or 'prior', got {source!r}")
    if not (seconds > 0.0 and math.isfinite(seconds)):
      raise ValueError(f"seconds must be positive and finite, got {seconds}")
    sig = signature(op, shape, dtype, backend, cfg)
    old = self.entries.get(sig)
    if old is not None and old.source == "measured" and source == "prior":
      return False
    self.entries[sig] = CostEntry(seconds=float(seconds), source=source)
    self._best_cache.clear()
    return True

  # -- reads -----------------------------------------------------------------

  def lookup(self, op: str, shape, dtype, backend: str,
             cfg: tuple = ()) -> Optional[CostEntry]:
    return self.entries.get(signature(op, shape, dtype, backend, cfg))

  def best(self, op: str, shape, dtype,
           backends: Optional[Sequence[str]] = None) -> Optional[Decision]:
    """Cheapest (backend, cfg) for one bucketed call signature, or None when
    the table holds nothing for it.  Ties break toward the earlier backend in
    ``backends`` order (deterministic dispatch)."""
    order = tuple(backends) if backends else ("xla", "vector", "pallas")
    m, k, n = bucket_shape(tuple(shape))
    prefix = f"{sr_mod.get(op).name}|{m}x{k}x{n}|{dtype_name(dtype)}|"
    cache_key = (prefix, order)
    if cache_key in self._best_cache:  # hot path: mmo resolves per call
      return self._best_cache[cache_key]
    choice: Optional[Decision] = None
    for sig, entry in self.entries.items():
      if not sig.startswith(prefix):
        continue
      backend, cfg_s = sig[len(prefix):].split("|")
      if backend not in order:
        continue
      cand = Decision(backend, _parse_cfg(cfg_s), entry.seconds, entry.source)
      if choice is None or (cand.seconds, order.index(cand.backend)) < (
          choice.seconds, order.index(choice.backend)):
        choice = cand
    self._best_cache[cache_key] = choice
    return choice

  def counts(self) -> dict:
    out = {"measured": 0, "prior": 0}
    for e in self.entries.values():
      out[e.source] += 1
    return out

  # -- persistence -----------------------------------------------------------

  def to_json(self) -> str:
    return json.dumps({
        "schema_version": self.version,
        "device": self.device,
        "entries": {sig: {"seconds": e.seconds, "source": e.source}
                    for sig, e in sorted(self.entries.items())},
    }, indent=2, sort_keys=True)

  @classmethod
  def from_json(cls, text: str) -> "CostTable":
    doc = json.loads(text)
    version = doc.get("schema_version")
    if version != SCHEMA_VERSION:
      raise ValueError(
          f"cost table schema_version {version!r} != {SCHEMA_VERSION} "
          "(re-run the autotuner to regenerate the table)")
    table = cls(device=doc.get("device", "unknown"))
    for sig, e in doc.get("entries", {}).items():
      entry = CostEntry(seconds=float(e["seconds"]), source=str(e["source"]))
      if entry.source not in ("measured", "prior"):
        raise ValueError(f"bad entry source {entry.source!r} at {sig!r}")
      if not (entry.seconds > 0.0 and math.isfinite(entry.seconds)):
        raise ValueError(f"bad entry seconds {entry.seconds!r} at {sig!r}")
      table.entries[sig] = entry
    return table

  def save(self, path) -> None:
    with open(path, "w") as f:
      f.write(self.to_json() + "\n")

  @classmethod
  def load(cls, path) -> "CostTable":
    with open(path) as f:
      return cls.from_json(f.read())
