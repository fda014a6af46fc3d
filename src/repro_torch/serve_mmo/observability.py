"""Request-lifecycle tracing: a bounded flight recorder over the serving path.

Counterpart of ``repro/serve_mmo/observability.py``, with its Chrome
trace-event set and, on top of it, the port's stage stamps.  Latency
percentiles say *how much* time a request spent; they never say *where*.
This module stamps spans at every state transition a request goes through
— submit, admit/reject, queued, batch pick, pad-and-stack, resolve+build,
device compute, split-results, done/expired/failed — and at every stage
of a batch, into a ``FlightRecorder``: a fixed-capacity ring buffer of
Chrome trace events.  A ring of the last N events costs one short lock +
one deque extend per emission and keeps memory constant under any load;
``stats()`` reports how many fell off the back, so a truncated window is
visible, never silent.

The export format is Chrome trace-event JSON (``export()`` →
``{"traceEvents": [...]}``), loadable in Perfetto / ``about://tracing``:

  * per-request lifecycle — nestable async events (``ph`` 'b'/'e', one id
    per request): a ``queued`` slice (submit → batch pick) followed by an
    ``execute`` slice (pick → results), with kind/op/tenant on the begin
    and the terminal outcome (done / expired / failed) on the end; a
    retried or bisected attempt closes its slice 'retried' and opens a new
    one (``batch_attempt_fail`` / ``batch_attempt_begin``).  An expired
    request's ``queued`` end says how long it waited and which batch was
    in service (bucket, size, pick time: the batch that just ended when
    the expiry is found between two batches);
  * per-batch phases — complete events (``ph`` 'X') on the executing
    thread's track: ``pad_and_stack``, ``resolve_compile`` (args say cache
    hit or miss), ``device_compute`` (the host-to-device copy, the launches
    and the device-to-host copy that waits for them; args carry backend,
    schedule, padded batch, H2D bytes, measured iterations),
    ``split_results``;
  * per-batch stages (``BatchStamps``, ``STAGES``), X events nested in the
    phases: on the executing thread's track the host stages ``stack`` (in
    pad_and_stack), ``h2d`` (the host's copy call) and one ``sync`` per
    host synchronisation of a closure's fixpoint loop (in device_compute;
    at most ``MAX_SYNC_SPANS`` a batch, each one observed by the metrics),
    ``nan_scan`` and ``split`` (in split_results); on the device track
    (``DEVICE_TID``) ``h2d``, ``compute``, ``select`` (KNN only) and
    ``d2h``, timed by CUDA events recorded at the stage boundaries and
    placed on the host clock by the event recorded when the last output
    copy returned (on a CPU engine, host times);
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
from typing import NamedTuple, Optional, Sequence

__all__ = ["FlightRecorder", "BatchStamps", "DEFAULT_TRACE_CAPACITY",
           "MAX_SYNC_SPANS", "STAGES", "DEVICE_TID"]

DEFAULT_TRACE_CAPACITY = 65536
# per-batch cap on emitted sync spans: a 1024-node Bellman-Ford bucket
# syncs up to 1023 times; tracing them all would let one batch evict half
# the ring (the metrics still observe every one)
MAX_SYNC_SPANS = 32
# a batch's stages, in the order they run (also ServeMetrics' stage windows)
STAGES = ("stack", "h2d", "compute", "select", "sync", "d2h", "nan_scan",
          "split")
# the device track: outside the range of host thread ids (masked to 31 bits)
DEVICE_TID = 1 << 31

_PID = 1  # one engine process per recorder


class StageRecord(NamedTuple):
  """One batch's stages, read from its ``BatchStamps``: (name, start,
  end) spans on the engine clock for the host track and the device track,
  (name, seconds) observations for the metrics (one per stage, one per
  sync) and the count of the batch's host synchronisations."""
  host: tuple
  device: tuple
  seconds: tuple
  syncs: int


class BatchStamps:
  """The stage stamps of one batch at a time, reused batch after batch (the
  engine pools them, so their CUDA events are made once).

  The engine calls ``begin`` before a batch, ``span`` for each host stage
  it times (stack, nan scan, split), ``boundary`` at the device stages'
  boundaries (``H2D`` before the host-to-device copy, ``COMPUTE`` after
  it, ``D2H`` before the first output copy, ``END`` when the last one
  returned), and installs the stamps through ``core.stamps`` around the
  batch function, whose fixpoint loops reach ``sync`` and whose KNN
  selection reaches ``mark``.  ``read`` gives the batch's ``StageRecord``.

  On a card each boundary records one of a fixed set of CUDA events, on
  the stream current when the set was made (the engine's: it launches on
  its device's current stream), beside the host time; nothing waits on an
  event.  ``read`` runs after the output copies returned, so every event
  before ``END`` has completed; ``END``, recorded on the stream those
  copies left idle, anchors the device stages at the host time it was
  recorded.  A batch whose ``END`` has not completed by then (elapsed_time
  refuses it) keeps host times for its device stages; so does every batch
  on a CPU engine.
  """

  H2D, COMPUTE, SELECT, D2H, END = range(5)

  def __init__(self, device=None, clock=None):
    self._clock = clock if clock is not None else time.perf_counter
    self._events = self._stream = None
    if device is not None and getattr(device, "type", device) == "cuda":
      import torch
      self._events = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(5))
      self._stream = torch.cuda.current_stream(device)
    self._at = [0.0] * 5
    self.begin()

  def begin(self) -> None:
    """Reset for the next batch."""
    self._host = []
    self._syncs = []
    self._at[self.SELECT] = None

  def span(self, name: str, t0_s: float, t1_s: float) -> None:
    self._host.append((name, t0_s, t1_s))

  def boundary(self, which: int) -> None:
    self._at[which] = self._clock()
    if self._events is not None:
      self._events[which].record(self._stream)

  def mark(self, stage: str) -> None:
    """``core.stamps.mark``: only the selection starts below the engine."""
    if stage == "select":
      self.boundary(self.SELECT)

  def sync(self, value, read):
    """``core.stamps.sync``: the host's wait in one synchronisation."""
    t0 = self._clock()
    out = read(value)
    self._syncs.append((t0, self._clock()))
    return out

  _PLAIN = (("h2d", "compute", "d2h"), (H2D, COMPUTE, D2H, END))
  _SELECTING = (("h2d", "compute", "select", "d2h"),
                (H2D, COMPUTE, SELECT, D2H, END))

  def read(self, copies: int) -> StageRecord:
    """The batch's record, after its last output copy returned and its
    host stages were spanned; ``copies`` is the outputs copied to the
    host (one synchronisation each)."""
    at = self._at
    names, idx = self._PLAIN if at[self.SELECT] is None else self._SELECTING
    times = [at[i] for i in idx]
    ev = self._events
    if ev is not None:
      end, t_end = ev[self.END], at[self.END]
      try:
        times[:-1] = [t_end - ev[i].elapsed_time(end) * 1e-3
                      for i in idx[:-1]]
      except RuntimeError:
        pass  # END not reached yet: host times
    device = [(n, times[k], times[k + 1]) for k, n in enumerate(names)]
    host = self._host
    seconds = [(n, t1 - t0) for n, t0, t1 in host]
    seconds += [(n, t1 - t0) for n, t0, t1 in device]
    syncs = self._syncs
    seconds += [("sync", t1 - t0) for t0, t1 in syncs]
    host.append(("h2d", at[self.H2D], at[self.COMPUTE]))
    host += [("sync", t0, t1) for t0, t1 in syncs[:MAX_SYNC_SPANS]]
    return StageRecord(host=host, device=device, seconds=seconds,
                       syncs=len(syncs) + copies)


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
                     iterations=None, emit_pick: bool = True,
                     stages: Optional[StageRecord] = None) -> None:
    """Emit one completed batch's whole event set in a single lock
    acquisition: the four phase spans (pad_and_stack / resolve_compile /
    device_compute / split_results), the batch's stage spans when
    ``stages`` carries them (host stages on this thread's track, device
    stages on ``DEVICE_TID``'s, held inside device_compute), and every
    member request's queued→execute transition (at the pick instant) and
    ``execute`` end (outcome done, with its latency).  This is the serving
    loop's only steady-state trace call, so its cost IS the tracing
    overhead the bench budgets.

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
      dev_args["iterations"] = [int(i) for i in iterations]
    if stages is not None:
      for name, t0, t1 in stages.host:
        events.append({"ph": "X", "cat": "stage", "name": name, "pid": _PID,
                       "tid": tid, "ts": t0 * 1e6,
                       "dur": max(0.0, (t1 - t0) * 1e6)})
      for name, t0, t1 in stages.device:
        # the anchor may put a boundary microseconds outside the phase
        ts0 = min(max(t0 * 1e6, ts_exec), ts_dev)
        ts1 = min(max(t1 * 1e6, ts0), ts_dev)
        events.append({"ph": "X", "cat": "device", "name": name,
                       "pid": _PID, "tid": DEVICE_TID, "ts": ts0,
                       "dur": ts1 - ts0})
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
    events = self.events()
    if any(ev.get("tid") == DEVICE_TID for ev in events):
      events.append({"ph": "M", "pid": _PID, "tid": DEVICE_TID,
                     "name": "thread_name",
                     "args": {"name": "device (CUDA events)"}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
