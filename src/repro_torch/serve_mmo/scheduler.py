"""Shape-bucketed request scheduler for the MMO serving engine.

Counterpart of ``repro/serve_mmo/scheduler.py``.  Requests land in buckets
keyed by (kind, op, padded shape, dtypes, static params).  Padding each
dimension up to the next power of two (with a floor) collapses the long
tail of problem shapes onto a handful of executables while bounding wasted
compute at <4×.

Which bucket batches next, and in what order requests leave it, is the
``SchedulingPolicy``'s decision (FIFO, deadline or fair share).  Deadline
bookkeeping lives here: ``add`` stamps each request's absolute
``deadline_at`` and ``next_batch`` diverts requests whose deadline already
passed — or that the policy declares hopeless — into the ``take_expired``
side channel instead of the batch.  The request arena's admission path uses
``peek_bucket`` / ``take_from`` instead: it looks at the policy's choice
first, then pops only as many requests as it has free slots.

With ``max_batch_seconds``, batches are also *service-time-capped* while
deadline-tagged traffic is around: the policy's ``batch_cap`` bounds each
batch to roughly that many predicted seconds of work (``predict_seconds``
× batch size), so a bulk batch on the card delays an urgent arrival by at
most the cap instead of a full ``max_batch`` service time.  Deadline
traffic counts as active while it is queued (a live counter) or was seen
within ``deadline_lookback_s`` of the last deadline-tagged submit, so
pure-bulk workloads keep full batches.
"""
from __future__ import annotations

import heapq
import time
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.serve_mmo.api import ProblemRequest
from repro_torch.serve_mmo.policy import FifoPolicy, QueueEntry, make_policy
from repro_torch.tuning.cost_table import MIN_BUCKET, bucket_dim, bucket_shape

__all__ = ["MIN_BUCKET", "BucketKey", "bucket_dim", "bucket_shape",
           "contract_shape", "request_bucket", "BucketScheduler",
           "FifoBucketScheduler"]


class BucketKey(NamedTuple):
  kind: str
  op: str
  shape: tuple     # padded problem shape
  dtypes: tuple    # one dtype string per operand, in operand order
  params: tuple


def contract_shape(key: BucketKey) -> tuple:
  """The (M, K, N) contraction a bucket's executable runs per request."""
  if key.kind == "mmo":
    return key.shape
  if key.kind == "closure":
    (nb,) = key.shape
    return (nb, nb, nb)
  if key.kind == "knn":
    qb, rb, db = key.shape  # addnorm contracts the feature dim
    return (qb, db, rb)
  raise ValueError(f"unknown kind {key.kind!r}")


def request_bucket(req: ProblemRequest,
                   min_bucket: int = MIN_BUCKET) -> BucketKey:
  """Deterministic bucket assignment for one request.  Every operand's dtype
  goes into the key: an executable is dtype-exact, so two requests may share
  it only if all their operands agree."""
  dtypes = tuple(str(np.dtype(a.dtype)) for a in req.arrays.values())
  return BucketKey(kind=req.kind, op=req.op,
                   shape=bucket_shape(req.shape, min_bucket),
                   dtypes=dtypes, params=req.params)


class BucketScheduler:
  """Request queue + policy-driven bucket picker (host-side).

  ``predict_seconds`` is an optional ``BucketKey → seconds`` hook (the
  engine wires it to ``MMOEngine.predict_request_seconds``) that the
  deadline policy's feasibility check and the batch cap read; without it,
  fail-fast degrades to plain already-expired detection and the cap is off.
  """

  DEADLINE_LOOKBACK_S = 1.0  # default recency window for the batch cap

  def __init__(self, *, policy="fifo", min_bucket: int = MIN_BUCKET,
               max_batch: int = 8, clock=None,
               max_batch_seconds: Optional[float] = None,
               deadline_lookback_s: Optional[float] = None):
    if max_batch < 1:
      raise ValueError("max_batch must be >= 1")
    if max_batch_seconds is not None and not max_batch_seconds > 0.0:
      raise ValueError(
          f"max_batch_seconds must be > 0, got {max_batch_seconds}")
    self.policy = make_policy(policy)
    self.min_bucket = min_bucket
    self.max_batch = max_batch
    self.max_batch_seconds = max_batch_seconds
    self.deadline_lookback_s = (self.DEADLINE_LOOKBACK_S
                                if deadline_lookback_s is None
                                else float(deadline_lookback_s))
    self.predict_seconds = None  # set by the engine (see MMOEngine)
    self._clock = clock if clock is not None else time.perf_counter
    self._buckets: dict[BucketKey, list[QueueEntry]] = {}  # heaps
    self._seq = 0
    # read by MMOEngine.observability_state: batches the policy picked and
    # the host seconds spent picking (perf_counter, never the injected
    # clock, so the exposed cost is the real scheduling overhead)
    self.picks = 0
    self.pick_seconds = 0.0
    self._expired: list[ProblemRequest] = []
    self._deadline_queued = 0          # deadline-tagged entries not yet popped
    self._last_deadline_s: Optional[float] = None  # last deadline-tagged add

  def __len__(self) -> int:
    return sum(len(q) for q in self._buckets.values())

  def add(self, req: ProblemRequest) -> BucketKey:
    now = self._clock()
    if req.deadline_s is not None and req.deadline_at is None:
      req.deadline_at = now + float(req.deadline_s)
    key = request_bucket(req, self.min_bucket)
    entry = QueueEntry(self._seq, req, self.policy.request_rank(req, now))
    self._seq += 1
    if req.deadline_at is not None:
      self._deadline_queued += 1
      self._last_deadline_s = now
    heapq.heappush(self._buckets.setdefault(key, []), entry)
    self.policy.on_add(entry, key, self)
    return key

  def deadline_traffic_active(self, now: float) -> bool:
    """Whether the service-time batch cap should bind: deadline-tagged work
    is queued right now, or arrived within the last ``deadline_lookback_s``
    (an ongoing deadline stream keeps bulk batches short *between* urgent
    arrivals: the arrival the cap protects is not queued yet when the bulk
    batch is built)."""
    if self._deadline_queued > 0:
      return True
    return (self._last_deadline_s is not None
            and now - self._last_deadline_s <= self.deadline_lookback_s)

  def pending_buckets(self) -> dict:
    return {k: len(q) for k, q in self._buckets.items() if q}

  def next_batch(self, now: Optional[float] = None) -> Optional[tuple]:
    """(BucketKey, [requests]) for the policy's chosen bucket, or None.

    Requests whose deadline already passed, or that the policy fails fast,
    are diverted to ``take_expired``; a pick whose bucket expires away
    entirely falls through to the next pick, so a non-None return always
    carries at least one live request.
    """
    if now is None:
      now = self._clock()
    t0 = time.perf_counter()
    try:
      return self._next_batch(now)
    finally:
      self.pick_seconds += time.perf_counter() - t0

  def _next_batch(self, now: float) -> Optional[tuple]:
    while True:
      key = self.policy.pick(self, now)
      if key is None:
        return None
      cap = min(self.max_batch, self.policy.batch_cap(key, self, now))
      batch = self._take_locked(key, cap, now)
      if batch:
        return key, batch

  def _take_locked(self, key, cap: int, now: float) -> list:
    """Pop up to ``cap`` live requests from one bucket's heap — the shared
    core of ``next_batch`` and ``take_from``.  Expired / failed-fast
    entries go to the side channel and do not count toward the cap; an
    emptied heap deletes its bucket."""
    heap = self._buckets.get(key)
    if not heap:  # stale pick (e.g. the bucket dict was cleared)
      self._buckets.pop(key, None)
      return []
    batch = []
    while heap and len(batch) < cap:
      entry = heapq.heappop(heap)
      if entry.taken:
        continue
      entry.taken = True
      if entry.req.deadline_at is not None:
        self._deadline_queued = max(0, self._deadline_queued - 1)
      deadline = entry.req.deadline_at
      if ((deadline is not None and deadline < now)
          or self.policy.fail_fast(entry, key, self, now)):
        self._expired.append(entry.req)
        continue
      batch.append(entry.req)
    if not heap:
      del self._buckets[key]
    if batch:
      self.policy.on_batch(key, batch, self)
      self.picks += 1
    return batch

  def peek_bucket(self, now: Optional[float] = None):
    """The policy's current bucket choice, popping nothing: the arena
    admission path peeks to decide whether the queue head is closure
    traffic (arena-served) or goes through the batch path.  Stale picks are
    cleaned up as in ``next_batch``."""
    if now is None:
      now = self._clock()
    while True:
      key = self.policy.pick(self, now)
      if key is None:
        return None
      if self._buckets.get(key):
        return key
      self._buckets.pop(key, None)

  def take_from(self, key, limit: int, now: Optional[float] = None) -> list:
    """Pop up to ``limit`` live requests from one given bucket — the arena
    admission path, where the free slot count (not max_batch) bounds how
    many leave the queue.  Same mechanics as ``next_batch``: expired
    entries are diverted and the policy's bookkeeping runs."""
    if now is None:
      now = self._clock()
    t0 = time.perf_counter()
    try:
      return self._take_locked(key, limit, now)
    finally:
      self.pick_seconds += time.perf_counter() - t0

  def take_expired(self) -> list:
    """Requests diverted by deadline expiry / fail-fast since the last
    call (drained by the engine, which fails their futures)."""
    expired, self._expired = self._expired, []
    return expired


class FifoBucketScheduler(BucketScheduler):
  """The scheduler pinned to the FIFO policy: strict FIFO within a bucket,
  oldest head first across buckets."""

  def __init__(self, *, min_bucket: int = MIN_BUCKET, max_batch: int = 8,
               clock=None):
    super().__init__(policy=FifoPolicy(), min_bucket=min_bucket,
                     max_batch=max_batch, clock=clock)
