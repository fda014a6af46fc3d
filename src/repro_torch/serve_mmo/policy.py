"""Scheduling policies: which bucket serves next, and in what order within.

Counterpart of ``repro/serve_mmo/policy.py``.  The scheduler owns request
storage — one heap per shape bucket — and delegates every ordering decision
to a ``SchedulingPolicy``:

  * ``request_rank``  orders requests within a bucket (submit seq breaks
    ties, so equal-rank requests stay FIFO),
  * ``pick``          chooses which bucket's head batches next,
  * ``fail_fast``     may declare a just-popped request hopeless,
  * ``batch_cap``     bounds how many requests the next batch may carry.

Only ``FifoPolicy`` is ported: strict FIFO within a bucket, oldest head
across buckets.  The deadline and fair-share policies come with the QoS
layer (ROADMAP Queue 1 item 6).

Cross-bucket picking is an O(log Q) lazy heap: every queued request pushes
one ``(rank, seq, bucket)`` record at add time; because bucket heaps share
the same (rank, seq) order, a live top record is always its bucket's
current head, and stale records are dropped at pick time.
"""
from __future__ import annotations

import heapq
from typing import Optional

__all__ = ["QueueEntry", "SchedulingPolicy", "FifoPolicy", "POLICIES",
           "make_policy"]


class QueueEntry:
  """One queued request: ``rank`` is the policy's within-bucket order prefix
  (seq breaks ties), ``taken`` marks entries already removed from their
  bucket so the pick heap can skip them lazily."""

  __slots__ = ("seq", "req", "rank", "taken")

  def __init__(self, seq: int, req, rank: tuple = ()):
    self.seq = seq
    self.req = req
    self.rank = rank
    self.taken = False

  def __lt__(self, other: "QueueEntry") -> bool:
    return (self.rank, self.seq) < (other.rank, other.seq)

  def __repr__(self) -> str:
    return (f"QueueEntry(seq={self.seq}, rank={self.rank}, "
            f"taken={self.taken})")


class SchedulingPolicy:
  """Base policy: heap-ordered bucket picking over ``request_rank``."""

  name = "base"

  def __init__(self):
    self._heap: list = []  # (rank, seq, BucketKey) — lazy, see module doc

  def request_rank(self, req, now: float) -> tuple:
    """Within-bucket order prefix for one request (seq breaks ties)."""
    return ()

  def on_add(self, entry: QueueEntry, key, sched) -> None:
    heapq.heappush(self._heap, (entry.rank, entry.seq, key))

  def pick(self, sched, now: float) -> Optional[tuple]:
    """BucketKey whose head serves next, or None when nothing is queued."""
    h = self._heap
    while h:
      _, seq, key = h[0]
      bucket = sched._buckets.get(key)
      if bucket and not bucket[0].taken and bucket[0].seq == seq:
        return key
      heapq.heappop(h)
    return None

  def fail_fast(self, entry: QueueEntry, key, sched, now: float) -> bool:
    """Whether a just-popped request should fail instead of execute."""
    return False

  def batch_cap(self, key, sched, now: float) -> int:
    """Most requests the next batch from ``key`` may carry."""
    return sched.max_batch

  def on_batch(self, key, batch, sched) -> None:
    """Called with every non-empty batch the scheduler built."""


class FifoPolicy(SchedulingPolicy):
  """Strict FIFO within a bucket; across buckets, oldest head first — the
  no-starvation default (a hot bucket cannot shadow a cold one)."""

  name = "fifo"


POLICIES = {"fifo": FifoPolicy}


def make_policy(policy) -> SchedulingPolicy:
  """'fifo' or a SchedulingPolicy instance (passed through; it holds queue
  state, so it must not be shared across schedulers)."""
  if isinstance(policy, SchedulingPolicy):
    return policy
  if policy in ("deadline", "fair"):
    raise NotImplementedError(
        f"policy {policy!r} is not ported yet (ROADMAP Queue 1 item 6, QoS "
        f"policies); the port serves 'fifo'")
  cls = POLICIES.get(policy)
  if cls is None:
    raise ValueError(f"unknown policy {policy!r}; one of "
                     f"{tuple(POLICIES)} or a SchedulingPolicy instance")
  return cls()
