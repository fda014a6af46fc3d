"""The batch-stage hook: how a serving batch's stamps reach code below it.

The serving engine stamps each stage of a batch where it runs
(``serve_mmo.observability.BatchStamps``).  Two kinds of stage happen
inside the batch function, below the engine: the host synchronisations of
the closure fixpoint loops (``core/closure.py``, the fused arm's chunk
loop in ``kernels/closure_megakernel.py``, the dp schedule in
``core/distributed.py``) and the start of the KNN selection
(``serve_mmo/batching.py``).  They reach the batch's stamps through this one
per-thread hook, which the engine installs around the batch function's
call in the thread that runs it, the watchdog's worker included.

With nothing installed (a direct caller of ``core.closure``, an engine with
``trace=False``) each call costs one attribute lookup and a return.
"""
from __future__ import annotations

import threading

__all__ = ["install", "clear", "current", "sync", "mark"]

_local = threading.local()


def install(stamps) -> None:
  """Stamp the batch this thread runs into ``stamps`` (``sync`` and
  ``mark`` calls go to it until ``clear``)."""
  _local.stamps = stamps


def clear() -> None:
  _local.stamps = None


def current():
  """The stamps installed in this thread, or None."""
  return getattr(_local, "stamps", None)


def sync(value, read=bool):
  """``read(value)``: one host synchronisation (a device tensor read on
  the host), stamped as a ``sync`` span when a batch is being stamped."""
  stamps = getattr(_local, "stamps", None)
  if stamps is None:
    return read(value)
  return stamps.sync(value, read)


def mark(stage: str) -> None:
  """A device stage starts here (its boundary is recorded on the stream
  when a batch is being stamped)."""
  stamps = getattr(_local, "stamps", None)
  if stamps is not None:
    stamps.mark(stage)
