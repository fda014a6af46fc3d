"""Executable cache — one built, static-shape batch function per key.

Counterpart of ``repro/serve_mmo/cache.py``, where a miss traces and
compiles a jax program ahead of time.  PyTorch runs eagerly, so here a miss
"compiles" by building the bucket's batch function (``make_fn``, which also
loads the kernel library for the kernel arm) and pinning it to the operand
shapes and dtypes it was built for: calling it with any other shapes raises
instead of silently running a different program.  CUDA-graph capture of
the batch function is later work.

Keys are (BucketKey, batch size, backend, block, schedule, mesh) as in the
reference; the hit/miss counters prove zero rebuilds in steady state.

Each entry also remembers whether it has run yet (``first_run``).  On a
card the first run of a batch function pays what building did not: CUDA
loads each kernel's module lazily, at its first launch (0.47–1.06 s on an
H100).  The engine keeps that first run out of its service-time estimator,
as the reference keeps compile time out, without running anything at build
time.

Thread-safety: the cache is shared between the caller thread (``prewarm``)
and the serving loop, so every ``_entries``/``_misses`` touch happens under
``_lock``.  Building runs outside the lock; two threads missing the same
key may both build, the first insert wins, and ``misses`` counts build
attempts (``misses >= executables``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch


class StaticShapeFn:
  """A batch function bound to one tuple of operand (shape, dtype)."""

  def __init__(self, fn: Callable, signature: tuple):
    self._fn = fn
    self.signature = signature

  def __call__(self, *args):
    got = tuple((tuple(a.shape), _dtype_name(a.dtype)) for a in args)
    if got != self.signature:
      raise ValueError(f"executable built for {self.signature}, called with "
                       f"{got}")
    return self._fn(*args)


def _dtype_name(dtype) -> str:
  """One spelling for numpy and torch dtypes ('float32', 'bool', …)."""
  if isinstance(dtype, torch.dtype):
    return str(dtype).removeprefix("torch.")
  return np.dtype(dtype).name


@dataclasses.dataclass
class CacheEntry:
  compiled: Callable
  compile_s: float
  hits: int = 0
  ran: bool = False  # executed at least once (see ``first_run``)


class ExecutableCache:
  def __init__(self):
    self._lock = threading.Lock()
    self._entries: dict = {}
    self._misses = 0

  @property
  def misses(self) -> int:
    with self._lock:
      return self._misses

  @property
  def hits(self) -> int:
    with self._lock:
      return sum(e.hits for e in self._entries.values())

  @property
  def compiles(self) -> int:
    return self.misses

  @property
  def compile_s(self) -> float:
    with self._lock:
      return sum(e.compile_s for e in self._entries.values())

  def __len__(self) -> int:
    with self._lock:
      return len(self._entries)

  def get_or_compile(self, exec_key, make_fn: Callable, args) -> Callable:
    """Return the built function for ``exec_key``, building on first use.

    ``make_fn`` builds the batch function; ``args`` are example operands or
    ``ShapeDtype``s fixing the shapes and dtypes it is built for.
    """
    with self._lock:
      entry = self._entries.get(exec_key)
      if entry is not None:
        entry.hits += 1
        return entry.compiled
      self._misses += 1
    t0 = time.perf_counter()
    signature = tuple((tuple(a.shape), _dtype_name(a.dtype)) for a in args)
    compiled = StaticShapeFn(make_fn(), signature)
    elapsed = time.perf_counter() - t0
    with self._lock:
      entry = self._entries.get(exec_key)
      if entry is not None:  # lost the build race: first insert wins
        entry.hits += 1
        return entry.compiled
      self._entries[exec_key] = CacheEntry(compiled=compiled,
                                           compile_s=elapsed)
    return compiled

  def first_run(self, exec_key) -> bool:
    """Mark ``exec_key``'s function as executed; True the first time only
    (a cold run), False afterwards and for unknown keys."""
    with self._lock:
      entry = self._entries.get(exec_key)
      if entry is None or entry.ran:
        return False
      entry.ran = True
      return True

  def stats(self) -> dict:
    with self._lock:
      return {
          "executables": len(self._entries),
          "hits": sum(e.hits for e in self._entries.values()),
          "misses": self._misses,
          "compile_s": round(
              sum(e.compile_s for e in self._entries.values()), 3),
      }
