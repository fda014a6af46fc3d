"""Request-lifecycle tracing: a bounded flight recorder over the serving path.

Counterpart of ``repro/serve_mmo/observability.py``, with the same Chrome
trace-event set.  Latency percentiles say *how much* time a request spent;
they never say *where*.  This module stamps spans at every state transition
a request goes through — submit, admit/reject, queued, batch pick,
pad-and-stack, resolve+build, device compute (with per-iteration slices for
closures), split-results, done/expired/failed — into a ``FlightRecorder``:
a fixed-capacity ring buffer of Chrome trace events.  A ring of the last N
events costs one short lock + one deque extend per emission and keeps
memory constant under any load; ``stats()`` reports how many fell off the
back, so a truncated window is visible, never silent.

The export format is Chrome trace-event JSON (``export()`` →
``{"traceEvents": [...]}``), loadable in Perfetto / ``about://tracing``:

  * per-request lifecycle — nestable async events (``ph`` 'b'/'e', one id
    per request): a ``queued`` slice (submit → batch pick) followed by an
    ``execute`` slice (pick → results), with kind/op/tenant on the begin
    and the terminal outcome (done / expired / failed) on the end; a
    retried or bisected attempt closes its slice 'retried' and opens a new
    one (``batch_attempt_fail`` / ``batch_attempt_begin``);
  * per-batch phases — complete events (``ph`` 'X') on the executing
    thread's track: ``pad_and_stack``, ``resolve_compile`` (args say cache
    hit or miss), ``device_compute`` (the host-to-device copy, the launches
    and the device-to-host copy that waits for them; args carry backend,
    schedule, padded batch, H2D bytes, measured iterations),
    ``split_results``;
  * closure iterations — the port's fixpoint syncs once per iteration or
    per fused chunk inside the device window, but the tracer does not stamp
    those syncs: it apportions the measured device window evenly across the
    batch's measured max iteration count into ``squaring_iter k`` slices
    (at most ``MAX_ITERATION_SLICES``), marked ``"apportioned": true``;
  * arena slots — ``arena_admit`` closes ``queued`` and opens ``execute``
    with the slot index, ``arena_tick`` X-events land inside it;
  * instants (``ph`` 'i') for admission rejections, batch failures,
    bisections and breaker transitions.

Timestamps come from the engine's injected clock (microseconds), so
synthetic-clock tests produce exact, deterministic traces.  The whole
per-batch event set is pushed in ONE ``batch_complete`` call, and
``enabled=False`` turns every hook into an attribute check + return.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Sequence

__all__ = ["FlightRecorder", "DEFAULT_TRACE_CAPACITY",
           "MAX_ITERATION_SLICES"]

DEFAULT_TRACE_CAPACITY = 65536
# per-batch cap on apportioned squaring_iter slices: a 1024-node
# Bellman-Ford bucket measures up to 1023 relaxations; tracing them all
# would let one batch evict half the ring
MAX_ITERATION_SLICES = 32

_PID = 1  # one engine process per recorder


class FlightRecorder:
  """Bounded ring buffer of Chrome trace events, thread-safe, O(1) append.

  Hooks are grouped by call site: ``request_begin`` (submit),
  ``request_rejected`` (admission), ``batch_complete`` (the whole per-batch
  event set in one emission), ``request_picked`` / ``request_end`` (the
  expire/fail paths, where requests terminate outside a completed batch),
  ``instant``.  Every hook is a no-op when ``enabled`` is False; callers
  with non-trivial args construction should still guard with
  ``if recorder.enabled:`` to keep the disabled path free."""

  def __init__(self, *, capacity: int = DEFAULT_TRACE_CAPACITY,
               clock=None, enabled: bool = True):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.capacity = int(capacity)
    self.enabled = bool(enabled)
    self._clock = clock if clock is not None else time.perf_counter
    self._lock = threading.Lock()
    self._events: collections.deque = collections.deque(maxlen=self.capacity)
    self._recorded = 0

  # -- clock -------------------------------------------------------------------

  def _ts(self, t_s: Optional[float] = None) -> float:
    """Trace timestamp in microseconds (Chrome trace's unit)."""
    return (self._clock() if t_s is None else t_s) * 1e6

  @staticmethod
  def _tid() -> int:
    return threading.get_ident() & 0x7FFFFFFF

  # -- raw emission ------------------------------------------------------------

  def _emit(self, events) -> None:
    with self._lock:
      self._events.extend(events)
      self._recorded += len(events)

  # -- request lifecycle (nestable async, one id per request) ------------------

  def request_begin(self, rid: int, *, kind: str, op: str, tenant: str,
                    t_s: Optional[float] = None) -> None:
    """The request was admitted and queued: open its ``queued`` slice."""
    if not self.enabled:
      return
    self._emit((
        {"ph": "b", "cat": "request", "id": rid, "name": "queued",
         "pid": _PID, "tid": self._tid(), "ts": self._ts(t_s),
         "args": {"kind": kind, "op": op, "tenant": tenant}},))

  def request_picked(self, rid: int, *, t_s: Optional[float] = None) -> None:
    """Queued slice ends, execute slice begins (batch pick) — used by the
    batch-failure path; completed batches ride ``batch_complete``."""
    if not self.enabled:
      return
    ts = self._ts(t_s)
    tid = self._tid()
    self._emit((
        {"ph": "e", "cat": "request", "id": rid, "name": "queued",
         "pid": _PID, "tid": tid, "ts": ts},
        {"ph": "b", "cat": "request", "id": rid, "name": "execute",
         "pid": _PID, "tid": tid, "ts": ts}))

  def request_end(self, rid: int, outcome: str, *, executing: bool,
                  t_s: Optional[float] = None,
                  args: Optional[dict] = None) -> None:
    """Close a request's open slice with its terminal outcome ('done',
    'expired', 'failed').  ``executing`` says which slice is open: True
    closes ``execute`` (the request was in a batch), False closes
    ``queued`` (it never left the queue)."""
    if not self.enabled:
      return
    end_args = {"outcome": outcome}
    if args:
      end_args.update(args)
    self._emit((
        {"ph": "e", "cat": "request", "id": rid,
         "name": "execute" if executing else "queued",
         "pid": _PID, "tid": self._tid(), "ts": self._ts(t_s),
         "args": end_args},))

  # -- arena slot lifecycle (admit → tick×k → evict) ---------------------------

  def arena_admit(self, rid: int, *, slot: int, bucket: str,
                  t_s: Optional[float] = None) -> None:
    """The request left the queue INTO an arena slot: its ``queued`` slice
    closes and its ``execute`` slice opens, carrying the slot index.  The
    slice stays open across every tick the request resides (``arena_tick``
    X-events land inside it) until ``request_end`` closes it at eviction —
    together the admit → tick×k → evict span of one slot residency."""
    if not self.enabled:
      return
    ts = self._ts(t_s)
    tid = self._tid()
    self._emit((
        {"ph": "e", "cat": "request", "id": rid, "name": "queued",
         "pid": _PID, "tid": tid, "ts": ts},
        {"ph": "b", "cat": "request", "id": rid, "name": "execute",
         "pid": _PID, "tid": tid, "ts": ts,
         "args": {"bucket": bucket, "slot": slot}}))

  def arena_tick(self, bucket: str, *, live: int, evicted: int, g: int,
                 t0_s: float, t1_s: float) -> None:
    """One arena tick (≤ g fused iterations over every live slot): a
    complete event on the serving thread's track, with occupancy and the
    sweep's eviction count in args."""
    if not self.enabled:
      return
    self._emit((
        {"ph": "X", "cat": "arena", "name": "arena_tick", "pid": _PID,
         "tid": self._tid(), "ts": t0_s * 1e6,
         "dur": max(0.0, (t1_s - t0_s) * 1e6),
         "args": {"bucket": bucket, "live": live, "evicted": evicted,
                  "g": g}},))

  def request_rejected(self, rid: int, reason: str, *, kind: str, op: str,
                       tenant: str, t_s: Optional[float] = None) -> None:
    """Admission refused the request: one instant — a rejection has no
    duration, so it gets a point on the timeline, not an async pair."""
    if not self.enabled:
      return
    self._emit((
        {"ph": "i", "cat": "admission", "name": "reject", "pid": _PID,
         "tid": self._tid(), "ts": self._ts(t_s), "s": "t",
         "args": {"id": rid, "reason": reason, "kind": kind, "op": op,
                  "tenant": tenant}},))

  # -- the completed-batch fast path -------------------------------------------

  def batch_complete(self, *, label: str, scheduled_s: float,
                     stacked_s: float, executed_s: float, device_s: float,
                     completed_s: float, backend: str, schedule: str,
                     batch: int, padded: int, h2d_bytes: int,
                     cache_hit: bool, request_ids: Sequence[int],
                     arrivals_s: Sequence[float],
                     iterations=None, emit_pick: bool = True) -> None:
    """Emit one completed batch's whole event set in a single lock
    acquisition: the four phase spans (pad_and_stack / resolve_compile /
    device_compute / split_results), the apportioned squaring-iteration
    slices for closures, and every member request's queued→execute
    transition (at the pick instant) and ``execute`` end (outcome done,
    with its latency).  This is the serving loop's only steady-state trace
    call, so its cost IS the tracing overhead the bench budgets.

    ``emit_pick=False`` skips the per-request queued→execute transition:
    retried/bisected sub-batches already closed ``queued`` and opened a
    fresh ``execute`` slice via ``batch_attempt_fail`` /
    ``batch_attempt_begin``, so only the terminal ``execute`` end is
    emitted here — one ``e`` per ``b`` per attempt."""
    if not self.enabled:
      return
    tid = self._tid()
    ts_sched = scheduled_s * 1e6
    ts_exec = executed_s * 1e6
    ts_dev = device_s * 1e6
    ts_done = completed_s * 1e6
    dev_args = {"bucket": label, "padded": padded, "backend": backend,
                "schedule": schedule, "h2d_bytes": h2d_bytes}
    events = [
        {"ph": "X", "cat": "batch", "name": "pad_and_stack", "pid": _PID,
         "tid": tid, "ts": ts_sched,
         "dur": max(0.0, (stacked_s - scheduled_s) * 1e6),
         "args": {"bucket": label, "batch": batch, "padded": padded,
                  "h2d_bytes": h2d_bytes}},
        {"ph": "X", "cat": "batch", "name": "resolve_compile", "pid": _PID,
         "tid": tid, "ts": stacked_s * 1e6,
         "dur": max(0.0, (executed_s - stacked_s) * 1e6),
         "args": {"bucket": label, "cache": "hit" if cache_hit else "miss",
                  "backend": backend, "schedule": schedule}},
        {"ph": "X", "cat": "batch", "name": "device_compute", "pid": _PID,
         "tid": tid, "ts": ts_exec, "dur": max(0.0, ts_dev - ts_exec),
         "args": dev_args},
        {"ph": "X", "cat": "batch", "name": "split_results", "pid": _PID,
         "tid": tid, "ts": ts_dev, "dur": max(0.0, ts_done - ts_dev),
         "args": {"bucket": label}},
    ]
    if iterations is not None and len(iterations):
      its = [int(i) for i in iterations]
      dev_args["iterations"] = its
      max_it = max(its)
      if max_it >= 1 and ts_dev > ts_exec:
        # see module docstring: apportioned slices, not stamped syncs
        n = min(max_it, MAX_ITERATION_SLICES)
        dur = (ts_dev - ts_exec) / n
        events.extend(
            {"ph": "X", "cat": "batch", "name": f"squaring_iter {i}",
             "pid": _PID, "tid": tid, "ts": ts_exec + i * dur, "dur": dur,
             "args": {"apportioned": True, "iterations": max_it}}
            for i in range(n))
    for rid, arrival_s in zip(request_ids, arrivals_s):
      if emit_pick:
        events.append({"ph": "e", "cat": "request", "id": rid,
                       "name": "queued", "pid": _PID, "tid": tid,
                       "ts": ts_sched})
        events.append({"ph": "b", "cat": "request", "id": rid,
                       "name": "execute", "pid": _PID, "tid": tid,
                       "ts": ts_sched})
      events.append({"ph": "e", "cat": "request", "id": rid,
                     "name": "execute", "pid": _PID, "tid": tid,
                     "ts": ts_done,
                     "args": {"outcome": "done",
                              "latency_ms": (completed_s - arrival_s) * 1e3}})
    self._emit(events)

  # -- the recovery path (retries / bisection) ---------------------------------

  def batch_attempt_begin(self, request_ids: Sequence[int], *,
                          t_s: Optional[float] = None) -> None:
    """Open a fresh ``execute`` slice for every member of a retried or
    bisected sub-batch — the previous attempt closed its slice with outcome
    'retried' (``batch_attempt_fail``), so each attempt reads as its own
    execute span under the request's async track."""
    if not self.enabled:
      return
    ts = self._ts(t_s)
    tid = self._tid()
    self._emit([{"ph": "b", "cat": "request", "id": rid, "name": "execute",
                 "pid": _PID, "tid": tid, "ts": ts}
                for rid in request_ids])

  def batch_attempt_fail(self, request_ids: Sequence[int], *, outcome: str,
                         picked_t_s: Optional[float] = None,
                         t_s: Optional[float] = None,
                         args: Optional[dict] = None) -> None:
    """Close every member's open ``execute`` slice after a failed attempt:
    ``outcome`` is 'retried' when recovery continues (retry or bisection)
    or 'failed' at the terminal attempt.  ``picked_t_s`` handles the first
    attempt, whose members never individually transitioned queued→execute
    (the success path batches that into ``batch_complete``): their
    ``queued`` end + ``execute`` begin are emitted first, at the pick
    time — keeping one ``e`` per ``b`` whichever way the attempt ends."""
    if not self.enabled:
      return
    ts = self._ts(t_s)
    tid = self._tid()
    events = []
    if picked_t_s is not None:
      ts_pick = picked_t_s * 1e6
      for rid in request_ids:
        events.append({"ph": "e", "cat": "request", "id": rid,
                       "name": "queued", "pid": _PID, "tid": tid,
                       "ts": ts_pick})
        events.append({"ph": "b", "cat": "request", "id": rid,
                       "name": "execute", "pid": _PID, "tid": tid,
                       "ts": ts_pick})
    end_args = {"outcome": outcome}
    if args:
      end_args.update(args)
    events.extend({"ph": "e", "cat": "request", "id": rid, "name": "execute",
                   "pid": _PID, "tid": tid, "ts": ts, "args": dict(end_args)}
                  for rid in request_ids)
    self._emit(events)

  def instant(self, name: str, *, cat: str = "engine",
              args: Optional[dict] = None,
              t_s: Optional[float] = None) -> None:
    if not self.enabled:
      return
    ev = {"ph": "i", "cat": cat, "name": name, "pid": _PID,
          "tid": self._tid(), "ts": self._ts(t_s), "s": "t"}
    if args:
      ev["args"] = args
    self._emit((ev,))

  # -- reading -----------------------------------------------------------------

  def events(self) -> list:
    """Snapshot of the live ring (oldest first)."""
    with self._lock:
      return list(self._events)

  def stats(self) -> dict:
    with self._lock:
      live = len(self._events)
      recorded = self._recorded
    return {"enabled": self.enabled, "capacity": self.capacity,
            "recorded": recorded, "live": live,
            "dropped": recorded - live}

  def clear(self) -> None:
    with self._lock:
      self._events.clear()
      self._recorded = 0

  def export(self, *, process_name: str = "serve_mmo engine") -> dict:
    """Chrome trace-event JSON object: load the dump in Perfetto or
    ``about://tracing``.  Metadata events name the process; async request
    slices and per-thread batch tracks come from the ring."""
    meta = [{"ph": "M", "pid": _PID, "name": "process_name",
             "args": {"name": process_name}}]
    return {"traceEvents": meta + self.events(), "displayTimeUnit": "ms"}
