"""Device-resident request arena: slot-based continuous batching for closures.

Counterpart of ``repro/serve_mmo/arena.py``.  The batch path holds every
closure request to its bucket's full fixpoint cycle: requests are padded
and stacked on the host, the whole batch runs to convergence, and an
arrival during the cycle waits for the next one.  The arena removes the
cycle.  It keeps a fixed-capacity slot buffer on the device — a
(capacity, n̄, n̄) iterate plus per-slot ``kv`` / ``act`` / ``it`` int32
vectors — and serves requests by slot lifecycle:

  admit — one indexed copy writes the padded adjacency into a free slot,
          from a pinned host buffer with a non-blocking copy; the slot
          index and the true n travel as a device tensor, so no other
          resident is restacked and the host never waits;
  tick  — one K2 launch (``kernels.closure_megakernel.fixpoint_chunk``)
          advances every live slot by up to ``g`` iterations, each under
          its own budget ``clamp(max_iters − it, 0, g)`` computed on the
          device; empty and finished slots cost one flag test in the kernel;
  sweep — the arena's one sync point: a device-to-host copy of ``act`` and
          ``it``, then every occupied slot that converged (act 0) or hit
          the cap is read out, freed and left for backfill.

Parity with the batch path holds by construction: both derive the layout
from one resolver (``chunk_geometry``) at the bucket dim ``nb``, the trip
cap is the batched solver's own ``fixpoint_iters(algorithm, nb)``, and the
kernel never mixes data across the request axis, so a slot's trajectory
does not depend on when its neighbours were admitted or evicted.

The three programs (admit / tick / read) are built once per arena through
the shared ``ExecutableCache``, pinned to the slot buffer's shapes; after
``prewarm`` every admission, tick and eviction replays them, and the
cache's miss counter stays flat.

Thread-safety: all host bookkeeping and the device-state swaps happen
under the arena's own lock.  The engine's lock order is engine → arena; the
arena never calls back into the engine.
"""
from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import closure as cl_mod
from repro_torch.core import semiring as sr_mod
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import closure_megakernel as _mk
from repro_torch.serve_mmo.api import ProblemRequest
from repro_torch.serve_mmo.batching import ShapeDtype
from repro_torch.serve_mmo.cache import ExecutableCache
from repro_torch.serve_mmo.scheduler import BucketKey

__all__ = ["DEFAULT_CAPACITY", "DEFAULT_ARENA_G", "Eviction", "RequestArena"]

DEFAULT_CAPACITY = 8
DEFAULT_ARENA_G = 4


class Eviction(NamedTuple):
  """One request leaving its slot: the engine turns this into a result."""
  request: ProblemRequest
  slot: int
  value: np.ndarray   # true-shape (n, n) closure
  iterations: int     # measured fixpoint trip count
  admit_s: float      # when the request entered its slot (engine clock)


class RequestArena:
  """Fixed-capacity device slot buffer for one closure bucket.

  Every request admitted here shares the bucket's (op, algorithm, nb,
  dtype) signature; the engine keeps one arena per closure ``BucketKey``.
  ``capacity`` bounds resident requests, ``g`` is the fused chunk length
  per tick, ``max_iters`` defaults to the batched solver's own trip cap at
  the bucket dim (it must stay nb-derived for parity with the batch path).
  """

  def __init__(self, key: BucketKey, *, capacity: int = DEFAULT_CAPACITY,
               g: int = DEFAULT_ARENA_G,
               cache: Optional[ExecutableCache] = None,
               max_iters: Optional[int] = None, device=DEFAULT_DEVICE,
               clock=None):
    if key.kind != "closure":
      raise ValueError(f"arena serves closure buckets only, got {key.kind!r}")
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    if g < 1:
      raise ValueError(f"g must be >= 1, got {g}")
    self.key = key
    (self.nb,) = key.shape
    self.op = key.op
    (self.algorithm,) = key.params
    self.capacity = int(capacity)
    self.g = int(g)
    self.cache = cache if cache is not None else ExecutableCache()
    self.device = resolve_device(device)
    self._clock = clock if clock is not None else time.perf_counter
    self.max_iters = (_mk.fixpoint_iters(self.algorithm, self.nb)
                      if max_iters is None else int(max_iters))
    self.geom = _mk.chunk_geometry(key.op, self.nb, key.dtypes[0])
    # Bellman-Ford relaxes against the admitted adjacency (D ← D ⊕ D⊗A);
    # Leyzorek squares the iterate against itself
    self._has_adj = self.algorithm == "bellman_ford"

    cap, np_, dev = self.capacity, self.geom.np_, self.device
    acc = self.geom.acc_dtype
    base = torch.full((np_, np_), sr_mod.saturate(self.geom.missing, acc),
                      dtype=acc)
    base.fill_diagonal_(sr_mod.saturate(self.geom.self_value, acc))
    # device slot state — swapped wholesale under _lock by tick
    self._c = base.expand(cap, np_, np_).contiguous().to(dev)
    self._adj = self._c.clone() if self._has_adj else None
    self._kv = torch.zeros(cap, dtype=torch.int32, device=dev)
    self._act = torch.zeros(cap, dtype=torch.int32, device=dev)
    self._it = torch.zeros(cap, dtype=torch.int32, device=dev)

    # host bookkeeping — guarded by _lock
    self._lock = threading.RLock()
    self._slots: List[Optional[ProblemRequest]] = [None] * cap
    self._admit_s: List[float] = [0.0] * cap
    self._free: List[int] = list(range(cap - 1, -1, -1))  # pop() → slot 0
    self._admitted = 0
    self._evicted = 0
    self._ticks = 0
    self._program_specs = self._build_program_specs()

  # -- programs --------------------------------------------------------------

  def _build_program_specs(self) -> dict:
    """name → (make_fn, operand specs) for the three arena programs.  The
    slot index and true size are data, so one program serves every slot and
    every request size in the bucket."""
    cap, np_ = self.capacity, self.geom.np_
    acc, i32 = self.geom.acc_dtype, torch.int32
    has_adj, op, g, max_iters = self._has_adj, self.op, self.g, self.max_iters
    on_card = self.device.type == "cuda"

    def make_admit():
      def admit(*args):
        if has_adj:
          c, adj, kv, act, it, mat, slot_n = args
        else:
          (c, kv, act, it, mat, slot_n), adj = args, None
        slot = slot_n[:1].long()
        c.index_copy_(0, slot, mat[None])
        if adj is not None:
          adj.index_copy_(0, slot, mat[None])
        kv.index_copy_(0, slot, slot_n[1:])
        act.index_fill_(0, slot, 1)
        it.index_fill_(0, slot, 0)
      return admit

    def make_tick():
      if on_card:
        _mk.load()  # build the kernel now, not on the first tick

      def tick(*args):
        if has_adj:
          c, adj, kv, act, it = args
        else:
          (c, kv, act, it), adj = args, None
        # each slot's remaining budget: a slot admitted mid-stream gets
        # exactly the iterations the batched path would have given it
        glim = (max_iters - it).clamp(0, g).to(i32)
        return _mk.fixpoint_chunk(c, adj, kv, act, it, glim, op=op,
                                  g_steps=g)
      return tick

    def make_read():
      def read(c, slot):
        # a copy even on the CPU: the slot is overwritten by its next tenant
        return c[int(slot)].to("cpu", copy=True)
      return read

    mat3, vec = ShapeDtype((cap, np_, np_), acc), ShapeDtype((cap,), i32)
    state = (mat3, mat3) if has_adj else (mat3,)
    return {
        "admit": (make_admit, state + (vec, vec, vec,
                                       ShapeDtype((np_, np_), acc),
                                       ShapeDtype((2,), i32))),
        "tick": (make_tick, state + (vec, vec, vec)),
        "read": (make_read, (mat3, ShapeDtype((), torch.int64))),
    }

  def _compiled(self, name: str):
    make_fn, specs = self._program_specs[name]
    return self.cache.get_or_compile(
        ("arena", self.key, name, self.capacity, self.g, self.max_iters,
         str(self.device)), make_fn, specs)

  def prewarm(self) -> None:
    """Build all three programs; after this, arena traffic builds nothing
    (the cache's miss counter stays flat)."""
    for name in self._program_specs:
      self._compiled(name)

  def _state(self) -> tuple:
    return ((self._c, self._adj) if self._has_adj else (self._c,)) + (
        self._kv, self._act, self._it)

  # -- slot lifecycle --------------------------------------------------------

  def free_slots(self) -> int:
    with self._lock:
      return len(self._free)

  def live_slots(self) -> int:
    with self._lock:
      return self.capacity - len(self._free)

  def live_requests(self) -> list:
    with self._lock:
      return [r for r in self._slots if r is not None]

  def admit(self, req: ProblemRequest, *, now: Optional[float] = None) -> int:
    """Write one request into a free slot; returns the slot index.  The
    padded adjacency is built on the host and copied from pinned memory
    without blocking; no other resident moves."""
    n = int(req.shape[0])
    if n > self.nb:
      raise ValueError(f"request n={n} exceeds arena bucket nb={self.nb}")
    mat = cl_mod.pad_adjacency(req.arrays["adj"], self.geom.np_, op=self.op)
    mat = torch.from_numpy(np.ascontiguousarray(mat)).to(
        self.geom.acc_dtype)
    slot_n_host = torch.empty(2, dtype=torch.int32)
    with self._lock:
      if not self._free:
        raise RuntimeError(
            f"arena full: {self.capacity} slots live — the engine must "
            f"bound admissions by free_slots()")
      slot = self._free.pop()
      slot_n_host[0], slot_n_host[1] = slot, n
      if self.device.type == "cuda":
        # a fresh pinned block per admission: the host allocator does not
        # reuse it until the copy that reads it has finished
        mat = mat.pin_memory().to(self.device, non_blocking=True)
        slot_n = slot_n_host.pin_memory().to(self.device, non_blocking=True)
      else:
        slot_n = slot_n_host
      self._compiled("admit")(*self._state(), mat, slot_n)
      self._slots[slot] = req
      self._admit_s[slot] = self._clock() if now is None else now
      self._admitted += 1
      return slot

  def tick(self) -> bool:
    """One K2 launch over the whole slot buffer (≤ g iterations per live
    slot).  Returns False without launching when no slot is occupied.  The
    launch is asynchronous: ``sweep`` is the synchronisation point."""
    with self._lock:
      if len(self._free) == self.capacity:
        return False
      self._c, self._it, self._act = self._compiled("tick")(*self._state())
      self._ticks += 1
      return True

  def sweep(self) -> List[Eviction]:
    """Evict every occupied slot that converged (act 0) or hit the trip
    cap: read its closure out and free the slot for backfill.  Runs
    strictly between ticks, so live slots' device state is untouched.
    Freed slots need no device write: their stale flags are inert (the next
    tick's budget or flag gives them no step) until an admission reseeds
    them."""
    with self._lock:
      act = self._act.cpu().numpy()  # waits for the tick: the one sync point
      it = self._it.cpu().numpy()
      read = self._compiled("read")
      evictions = []
      for slot, req in enumerate(self._slots):
        if req is None or (act[slot] != 0 and it[slot] < self.max_iters):
          continue
        n = int(req.shape[0])
        value = read(self._c, torch.tensor(slot)).numpy()[:n, :n]
        evictions.append(Eviction(request=req, slot=slot, value=value,
                                  iterations=int(it[slot]),
                                  admit_s=self._admit_s[slot]))
        self._slots[slot] = None
        self._free.append(slot)
        self._evicted += 1
      return evictions

  def reset(self) -> list:
    """Abandon all resident requests (tick-failure recovery): zero the
    per-slot flags, free every slot, and return the forfeited requests for
    the engine to fail.  The iterate needs no wipe: admission overwrites a
    slot's matrix whole."""
    with self._lock:
      live = [r for r in self._slots if r is not None]
      self._slots = [None] * self.capacity
      self._admit_s = [0.0] * self.capacity
      self._free = list(range(self.capacity - 1, -1, -1))
      self._kv = torch.zeros_like(self._kv)
      self._act = torch.zeros_like(self._act)
      self._it = torch.zeros_like(self._it)
      return live

  def stats(self) -> dict:
    with self._lock:
      live = self.capacity - len(self._free)
      return {"capacity": self.capacity, "live": live,
              "free": len(self._free), "admitted": self._admitted,
              "evicted": self._evicted, "ticks": self._ticks,
              "g": self.g, "max_iters": self.max_iters}
