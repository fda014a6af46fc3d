"""The MMO serving engine: micro-batching over shape buckets, with QoS.

Counterpart of ``repro/serve_mmo/engine.py``, in both modes:
``mode="batch"`` serves each bucket batch to completion, and
``mode="arena"`` serves closure buckets from a device-resident slot buffer
(serve_mmo/arena.py) that admits requests between fused K2 ticks, while
other buckets still batch.  One engine owns a policy-driven bucket
scheduler (FIFO, deadline or fair share: serve_mmo/policy.py), an
admission controller (``max_queue`` / ``tenant_quota`` / ``max_backlog_s``:
serve_mmo/admission.py), a live metrics registry (``metrics_snapshot()``
works mid-run from any thread: serve_mmo/metrics.py), the service-time
estimator (serve_mmo/estimator.py), an executable cache and the request
bookkeeping; it runs on one device (``device="cuda"`` by default, which
raises without a card).  Two ways to run it:

  * synchronous — ``submit()`` then ``step()`` / ``run_until_idle()`` (or
    just ``future.result()``, which drives steps lazily);
  * background loop — ``start()`` spawns a serving thread that batches
    whatever is queued as fast as it drains; ``submit()`` is then fully
    async and ``future.result()`` blocks on the completion event.

Batches execute outside the queue lock, so a long closure batch never
blocks concurrent ``submit`` calls.  A batch's results are NaN-validated
before any future is fulfilled; a failed batch fails all of its requests,
and a failed arena tick fails every resident of that arena (retry and
bisection come with the resilience layer).

``backend="auto"`` resolves each bucket's arm and block config from the
cost table (``cost_table=``, else the process-global table: see
repro_torch.tuning.dispatch); closure buckets choose among
``CLOSURE_BACKENDS``, the fused arm included.  Every QoS feature reads one
number, the predicted seconds per request (``predict_request_seconds``):
the static per-contraction cost from the table or the H100 prior times the
bucket's trip count, or with ``adaptive=True`` the estimator's live EWMA
of measured service.  The first run of each batch function is kept out of
that EWMA (on a card it pays CUDA's lazy module load).

The reference engine's other knobs belong to modules not ported yet.  Each
is accepted by name and raises ``NotImplementedError`` naming its
ROADMAP.md item when set to anything but its inert value; none is silently
ignored.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.mmo import BACKENDS
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.serve_mmo import batching
from repro_torch.serve_mmo.admission import AdmissionController
from repro_torch.serve_mmo.api import (DeadlineExceededError, MMOFuture,
                                       MMOResult, NonFiniteResultError,
                                       ProblemRequest, RejectedError)
from repro_torch.serve_mmo.arena import (DEFAULT_ARENA_G, DEFAULT_CAPACITY,
                                         RequestArena)
from repro_torch.serve_mmo.cache import ExecutableCache
from repro_torch.serve_mmo.estimator import Estimate, ServiceEstimator
from repro_torch.serve_mmo.metrics import ServeMetrics, bucket_label
from repro_torch.serve_mmo.scheduler import (BucketScheduler, MIN_BUCKET,
                                             bucket_dim, contract_shape,
                                             request_bucket)

_ITEM9_OBS = "Queue 1 item 9 (tracing and HTTP observability)"
_ITEM9_RES = "Queue 1 item 9 (resilience: faults, retries, breakers)"
_ITEM11 = "Queue 1 item 11 (distributed schedules)"

# reference knob → (values that ask for nothing, ROADMAP.md item porting it)
_UNPORTED_KNOBS = {
    "mesh": ((None,), _ITEM11),
    "schedule": (("auto", "local"), _ITEM11),
    "shard_flops": ((None,), _ITEM11),
    "trace": ((False,), _ITEM9_OBS),
    "trace_capacity": ((None,), _ITEM9_OBS),
    "tracer": ((None,), _ITEM9_OBS),
    "faults": ((None,), _ITEM9_RES),
    "transient_retries": ((0,), _ITEM9_RES),
    "retry_backoff_s": ((None,), _ITEM9_RES),
    "bisect": ((False,), _ITEM9_RES),
    "breaker_threshold": ((None,), _ITEM9_RES),
    "breaker_probe_s": ((None,), _ITEM9_RES),
    "watchdog_s": ((None,), _ITEM9_RES),
    "fallback_backends": ((None,), _ITEM9_RES),
    "resilience": ((None,), _ITEM9_RES),
}
# the engine-wide backends: the per-contraction arms, the fused fixpoint
# arm, which serves closure buckets (others take 'pallas'), and 'auto'
ENGINE_BACKENDS = BACKENDS + ("megakernel", "auto")
MODES = ("batch", "arena")
# every bucket runs on the one device: the estimator's schedule key
_LOCAL = "local"
# the arena's arm for estimator accounting: one per closure bucket
_ARENA = "arena"


def _check_knobs(knobs: dict) -> None:
  for name, value in knobs.items():
    if name not in _UNPORTED_KNOBS:
      raise TypeError(f"MMOEngine() got an unexpected keyword argument "
                      f"{name!r}")
    inert, item = _UNPORTED_KNOBS[name]
    if not any(value is v or (type(value) is type(v) and value == v)
               for v in inert):
      raise NotImplementedError(
          f"MMOEngine({name}={value!r}) is not ported yet: see ROADMAP.md "
          f"{item}")


def _to_numpy(x) -> np.ndarray:
  return x.detach().cpu().numpy()


@dataclasses.dataclass
class RequestRecord:
  request_id: int
  kind: str
  op: str
  bucket: tuple
  batch_size: int
  arrival_s: float
  scheduled_s: float
  completed_s: float

  @property
  def latency_s(self) -> float:
    return self.completed_s - self.arrival_s


@dataclasses.dataclass
class EngineStats:
  completed: int
  batches: int
  mean_batch: float
  latencies_s: np.ndarray
  cache: dict
  rejected: int = 0
  expired: int = 0

  def percentile(self, q: float) -> float:
    if len(self.latencies_s) == 0:
      return float("nan")
    return float(np.percentile(self.latencies_s, q))

  def summary(self) -> str:
    if len(self.latencies_s):
      lat = (f"p50={self.percentile(50) * 1e3:.1f}ms "
             f"p99={self.percentile(99) * 1e3:.1f}ms")
    else:
      lat = "p50=n/a p99=n/a"
    return (f"completed={self.completed} batches={self.batches} "
            f"mean_batch={self.mean_batch:.2f} {lat} "
            f"rejected={self.rejected} expired={self.expired} "
            f"cache_hits={self.cache['hits']} "
            f"cache_misses={self.cache['misses']}")


class MMOEngine:
  """Serving engine for semiring problem requests (see api.py).

  ``backend`` is one of ``ENGINE_BACKENDS`` ('pallas' — the SIMD² unit
  kernel — by default; 'megakernel' runs closure buckets through the fused
  fixpoint K2 and every other bucket through 'pallas'; 'auto' resolves
  backend and block config per bucket from the cost table, memoized per
  bucket and baked into the executable-cache key).  ``max_batch`` bounds a
  batch and ``min_bucket`` floors the padded shape.  ``clock`` injects a
  monotonic time source for arrival/deadline/metrics bookkeeping.

  QoS: ``policy`` is 'fifo' (the default), 'deadline', 'fair' or a
  SchedulingPolicy instance; ``max_queue`` / ``tenant_quota`` /
  ``max_backlog_s`` configure admission (all None admits everything), or
  ``admission`` passes a controller.  Requests carrying ``deadline_s`` that
  are still queued past their deadline fail with ``DeadlineExceededError``
  under every policy.  ``adaptive=True`` answers the per-request prediction
  from the estimator (``estimator=`` to pass one); ``max_batch_seconds``
  caps bulk batches to about that many predicted seconds while deadline
  traffic is active (``deadline_lookback_s`` after the last one).
  ``metrics_window`` sizes the rolling latency windows.

  ``mode="arena"`` serves closure buckets from one ``RequestArena`` each
  (``arena_capacity`` slots, ``arena_g`` fused iterations per tick): queued
  closure requests enter free slots the moment they reach the queue head,
  every live slot advances one K2 launch per step, and each request
  completes when its slot converges — whatever the arm ``backend`` names.
  """

  def __init__(self, *, backend: str = "pallas", max_batch: int = 8,
               min_bucket: int = MIN_BUCKET, device=DEFAULT_DEVICE,
               cost_table=None, policy="fifo",
               max_queue: Optional[int] = None, tenant_quota=None,
               max_backlog_s: Optional[float] = None,
               admission: Optional[AdmissionController] = None,
               clock=None, metrics_window: int = 512,
               adaptive: bool = False,
               estimator: Optional[ServiceEstimator] = None,
               max_batch_seconds: Optional[float] = None,
               deadline_lookback_s: Optional[float] = None,
               validate_results: bool = True,
               mode: str = "batch", arena_capacity: int = DEFAULT_CAPACITY,
               arena_g: int = DEFAULT_ARENA_G, **knobs):
    _check_knobs(knobs)
    if mode not in MODES:
      raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if backend not in ENGINE_BACKENDS:
      raise ValueError(f"unknown backend {backend!r}; one of "
                       f"{ENGINE_BACKENDS}")
    if arena_capacity < 1 or arena_g < 1:
      raise ValueError(f"arena_capacity and arena_g must be >= 1, got "
                       f"{arena_capacity} and {arena_g}")
    self.device = resolve_device(device)
    self.backend = backend
    self.cost_table = cost_table
    self.mode = mode
    self.arena_capacity = int(arena_capacity)
    self.arena_g = int(arena_g)
    self.validate_results = bool(validate_results)
    self._clock = clock if clock is not None else time.perf_counter
    self._decisions: dict = {}  # BucketKey → (backend, block cfg)
    self._static_cost: dict = {}  # BucketKey → (contraction s, worst trips)
    self.adaptive = bool(adaptive)
    self.estimator = estimator if estimator is not None else ServiceEstimator()
    self.scheduler = BucketScheduler(policy=policy, min_bucket=min_bucket,
                                     max_batch=max_batch, clock=self._clock,
                                     max_batch_seconds=max_batch_seconds,
                                     deadline_lookback_s=deadline_lookback_s)
    self.scheduler.predict_seconds = self.predict_request_seconds
    if admission is None:
      admission = AdmissionController(max_queue=max_queue,
                                      tenant_quota=tenant_quota,
                                      max_backlog_s=max_backlog_s)
    self.admission = admission
    self.metrics = ServeMetrics(clock=self._clock, window=metrics_window)
    self.cache = ExecutableCache()
    self._lock = threading.RLock()
    self._work = threading.Condition(self._lock)
    self._idle = threading.Condition(self._lock)  # signaled: _pending empty
    self._records: list[RequestRecord] = []
    self._batches = 0
    self._rejected = 0
    self._expired = 0
    self._next_id = 0
    self._pending: dict[int, MMOFuture] = {}
    self._inflight: set[int] = set()  # popped from the queue, executing now
    self._arenas: dict = {}  # closure BucketKey → RequestArena
    self._arenas_ticked: set = set()  # arenas past their first (cold) tick
    self._arena_cold: set = set()  # request ids resident in a cold tick
    self._thread: Optional[threading.Thread] = None
    self._running = False
    self._stopped = False  # stop() was called; submit refuses until start()

  # -- prediction --------------------------------------------------------------

  @staticmethod
  def _iteration_factor(key) -> float:
    """Contractions one request in this bucket runs: 1 for mmo/knn, the
    solver's worst-case trip count for closures (Leyzorek squares ~lg(nb)
    times, Bellman-Ford relaxes up to nb−1 times).  A cost-table row is one
    contraction; service predictions scale by this."""
    if key.kind != "closure":
      return 1.0
    (nb,) = key.shape
    (algorithm,) = key.params
    if algorithm == "bellman_ford":
      return float(max(1, nb - 1))
    return float(max(1, math.ceil(math.log2(nb))))

  def _static_point(self, key) -> tuple:
    """(per-contraction seconds, worst-case trips) for one bucket — the
    static prior the adaptive path corrects: ``tuning.dispatch.
    contraction_seconds`` (a measured table row when someone measured the
    point, else the H100 prior), memoized per bucket under the engine
    lock."""
    with self._lock:
      memo = self._static_cost.get(key)
      if memo is None:
        from repro_torch.tuning import dispatch as _dispatch
        m, k, n = contract_shape(key)
        # arena-mode closure buckets run on the arena arm, so their prior
        # prices slot-seconds there; the fused arm serves only closures
        backend = self.backend
        if self.mode == "arena" and key.kind == "closure":
          backend = _ARENA
        elif backend == "megakernel" and key.kind != "closure":
          backend = "pallas"
        _, _, s = _dispatch.contraction_seconds(
            key.op, m, k, n, key.dtypes[0], backend=backend,
            table=self.cost_table)
        memo = (s, self._iteration_factor(key))
        self._static_cost[key] = memo
      return memo

  def predict_request(self, key) -> Estimate:
    """Predicted service seconds for ONE request of this bucket, with its
    provenance.  Batch compute scales with occupied slots, so this is also
    the request's share of a batch and of the queue's backlog: what the
    deadline policy's feasibility check, backlog admission and the batch
    cap consume.  Non-adaptive engines answer the static prediction
    (per-contraction cost × worst-case trips); adaptive ones ask the
    estimator (warm EWMA, then static × measured iterations, then
    static)."""
    contraction_s, trips = self._static_point(key)
    if not self.adaptive:
      return Estimate(contraction_s * trips, "static")
    if self.mode == "arena" and key.kind == "closure":
      return self.estimator.predict(key, _ARENA, _LOCAL, contraction_s,
                                    trips)
    backend, _ = self.resolve_backend(key)
    return self.estimator.predict(key, backend, _LOCAL, contraction_s, trips)

  def predict_request_seconds(self, key) -> float:
    """``predict_request`` without the provenance: the scheduler hook."""
    return self.predict_request(key).seconds

  # -- submission ------------------------------------------------------------

  def submit(self, req: ProblemRequest) -> MMOFuture:
    """Queue one request; returns its future.  Admission may refuse: the
    future then arrives already failed with ``RejectedError`` (state
    'rejected') and nothing was queued.  Raises RuntimeError after
    ``stop()`` until ``start()`` is called again."""
    fut = MMOFuture(self, req)
    with self._work:
      if self._stopped:
        raise RuntimeError(
            "submit() on a stopped engine: stop() shut the serving loop "
            "down; call start() to resume accepting requests")
      req.request_id = self._next_id
      self._next_id += 1
      req.arrival_s = self._clock()
      if req.deadline_s is not None and req.deadline_at is None:
        req.deadline_at = req.arrival_s + float(req.deadline_s)
      cost = 0.0
      if self.admission.max_backlog_s is not None:
        est = self.predict_request(
            request_bucket(req, self.scheduler.min_bucket))
        cost = est.seconds
        req.predicted_source = est.source
      verdict = self.admission.try_admit(req, cost_s=cost)
      if verdict is not None:
        kind, reason = verdict
        self._rejected += 1
        self.metrics.on_reject(kind)
        fut._fail(RejectedError(
            f"request {req.request_id} ({req.kind}/{req.op}) rejected: "
            f"{reason}"))
        return fut
      self.metrics.on_submit()
      self.scheduler.add(req)
      self._pending[req.request_id] = fut
      self._work.notify()
    return fut

  def pending(self) -> int:
    with self._lock:
      return len(self._pending)

  # -- execution -------------------------------------------------------------

  @staticmethod
  def _batch_bucket(r: int) -> int:
    """Round the batch size up to a power of two: the request axis is
    bucketed like the problem axes, so one bucket spawns at most
    log2(max_batch)+1 executables instead of one per arrival count."""
    return bucket_dim(r, 1)

  def resolve_backend(self, key) -> tuple:
    """(backend, block cfg) for one bucket — the dispatch decision.

    Memoized: the first resolution a bucket gets is the one it keeps for
    the engine's lifetime (stable executable-cache keys).  The whole
    check-resolve-memoize sequence holds the engine lock, so ``prewarm`` on
    a caller thread and ``step`` on the serving loop cannot memoize two
    decisions for one bucket.  Under 'auto', closure buckets choose among
    ``CLOSURE_BACKENDS`` (the fused arm included) and other buckets among
    the per-contraction arms; the fused arm serves closure buckets only,
    so under 'megakernel' the others take the kernel arm.
    """
    with self._lock:
      dec = self._decisions.get(key)
      if dec is None:
        if self.backend == "auto":
          from repro_torch.tuning import dispatch as _dispatch
          m, k, n = contract_shape(key)
          pool = (_dispatch.CLOSURE_BACKENDS if key.kind == "closure"
                  else None)
          d = _dispatch.resolve(key.op, m, k, n, key.dtypes[0],
                                table=self.cost_table, backends=pool)
          # K1 chooses its own tile: a 'pallas' row's cfg does not apply
          dec = (d.backend, () if d.backend == "pallas" else d.cfg)
        elif self.backend == "megakernel" and key.kind != "closure":
          dec = ("pallas", ())
        else:
          dec = (self.backend, ())
        self._decisions[key] = dec
      return dec

  def _exec_key(self, key, rb: int, backend: str, block: tuple,
                schedule: str) -> tuple:
    """Executable-cache key, laid out as the reference's (placement
    included; the mesh slot stays None until sharding is ported)."""
    return (key, rb, backend, block, schedule, None)

  def _build(self, key, rb: int, args) -> tuple:
    """(executable-cache key, batch function) for one (bucket, batch)."""
    backend, block = self.resolve_backend(key)
    exec_key = self._exec_key(key, rb, backend, block, _LOCAL)
    fn = self.cache.get_or_compile(
        exec_key,
        lambda: batching.make_batch_fn(key, backend=backend, block=block,
                                       device=self.device),
        args)
    return exec_key, fn

  def _expire_locked(self, reqs) -> None:
    """Fail requests whose deadline passed while queued, or that the policy
    failed fast as hopeless.  Engine lock held."""
    self._expired += len(reqs)
    for r in reqs:
      self.admission.on_dequeue(r)
      self.admission.on_done(r)
      self.metrics.on_expire(request_bucket(r, self.scheduler.min_bucket))
      fut = self._pending.pop(r.request_id, None)
      if fut is not None:
        fut._fail(DeadlineExceededError(
            f"request {r.request_id} ({r.kind}/{r.op}) missed its "
            f"{r.deadline_s:g}s deadline while queued"))
    if not self._pending:
      self._idle.notify_all()

  def step(self) -> int:
    """Serve one engine step; returns #requests completed.  Batch mode
    schedules + executes one bucket batch.  Arena mode admits queued
    closure requests into free slots, runs one batch step when the queue
    head is not closure traffic, then ticks every live arena and completes
    its evictions."""
    if self.mode == "arena":
      return self._step_arena()
    return self._step_batch()

  def _step_batch(self) -> int:
    """Schedule + execute one bucket batch; returns #requests completed."""
    with self._lock:
      picked = self.scheduler.next_batch(now=self._clock())
      expired = self.scheduler.take_expired()
      if expired:
        self._expire_locked(expired)
      if picked is None:
        return 0
      key, reqs = picked
      for r in reqs:
        self.admission.on_dequeue(r)
      self._inflight.update(r.request_id for r in reqs)
    scheduled_s = self._clock()
    try:
      results, info = self._execute(key, reqs, scheduled_s)
    except Exception as e:  # noqa: BLE001 — the batch fails, serving goes on
      self._fail_requests(key, reqs, e)
      return 0
    return self._complete(key, reqs, results, info, scheduled_s)

  def _execute(self, key, reqs, start_s: float) -> tuple:
    """Stack, build (cache), run on the device, validate and split.
    Returns (results, timing info) and feeds the estimator."""
    rb = self._batch_bucket(len(reqs))
    backend, _ = self.resolve_backend(key)
    # fill the padded batch slots with copies of the last request — wasted
    # compute bounded at 2×, in exchange for a bounded executable set
    stacked = batching.stack_batch(key, reqs + [reqs[-1]] * (rb - len(reqs)))
    h2d_bytes = sum(int(x.nbytes) for x in stacked)
    stacked_s = self._clock()
    exec_key, compiled = self._build(key, rb, stacked)
    # service observations start after the build, as the reference's start
    # after compiling
    executed_s = self._clock()
    out = compiled(*batching.to_device(stacked, self.device))
    # the device-to-host copy is the batch's synchronisation point
    out = (tuple(_to_numpy(x) for x in out)
           if isinstance(out, (tuple, list)) else _to_numpy(out))
    device_s = self._clock()
    cold = self.cache.first_run(exec_key)
    if key.kind == "closure":
      # measured convergence counts of the live slots (padded slots copy
      # the last request), recorded before validation can fail the batch
      self.estimator.observe_iterations(key, np.asarray(out[1])[:len(reqs)])
    if self.validate_results:
      bad = batching.validate_finite(key, out, len(reqs))
      if bad:
        # NaN means the arm misbehaved (±inf is legitimate tropical output)
        raise NonFiniteResultError(bucket_label(key), bad)
    results = batching.split_results(key, reqs, out)
    if len(results) != len(reqs):
      raise RuntimeError(f"split_results returned {len(results)} results "
                         f"for {len(reqs)} requests in {bucket_label(key)}")
    completed_s = self._clock()
    if not cold:
      # per padded slot; a function's first run (lazy module loads on a
      # card) would inflate the EWMA by orders of magnitude
      self.estimator.observe_batch(key, backend, _LOCAL, rb,
                                   completed_s - executed_s)
    info = {"start_s": start_s, "stacked_s": stacked_s,
            "executed_s": executed_s, "device_s": device_s,
            "completed_s": completed_s, "h2d_bytes": h2d_bytes}
    return results, info

  def _complete(self, key, reqs, results, info, scheduled_s: float) -> int:
    completed_s = info["completed_s"]
    with self._lock:
      self._batches += 1
      self.metrics.on_batch(
          key,
          host_s=((info["stacked_s"] - info["start_s"])
                  + (completed_s - info["device_s"])),
          device_s=info["device_s"] - info["executed_s"],
          h2d_bytes=info["h2d_bytes"])
      for r, res in zip(reqs, results):
        self._inflight.discard(r.request_id)
        self._records.append(RequestRecord(
            request_id=r.request_id, kind=r.kind, op=r.op, bucket=tuple(key),
            batch_size=len(reqs), arrival_s=r.arrival_s,
            scheduled_s=scheduled_s, completed_s=completed_s))
        self.admission.on_done(r)
        self.metrics.on_complete(key, queue_s=scheduled_s - r.arrival_s,
                                 service_s=completed_s - scheduled_s)
        fut = self._pending.pop(r.request_id, None)
        if fut is not None:
          fut._fulfill(res)
      if not self._pending:
        self._idle.notify_all()
    return len(reqs)

  def _fail_requests(self, key, reqs, exc) -> None:
    with self._lock:
      for r in reqs:
        self._inflight.discard(r.request_id)
        self._arena_cold.discard(r.request_id)
        self.admission.on_done(r)
        self.metrics.on_fail(key)
        fut = self._pending.pop(r.request_id, None)
        if fut is not None:
          fut._fail(exc)
      if not self._pending:
        self._idle.notify_all()

  # -- arena mode ------------------------------------------------------------

  def _arena_for_locked(self, key) -> RequestArena:
    """One arena per closure bucket, created on first use.  Engine lock
    held."""
    arena = self._arenas.get(key)
    if arena is None:
      arena = RequestArena(key, capacity=self.arena_capacity, g=self.arena_g,
                           cache=self.cache, device=self.device,
                           clock=self._clock)
      self._arenas[key] = arena
    return arena

  def _arena_live_locked(self) -> bool:
    """Whether any arena holds resident requests.  Engine lock held; part
    of every drain condition — an empty queue alone no longer means idle."""
    return any(a.live_slots() for a in self._arenas.values())

  def _step_arena(self) -> int:
    """One arena-mode step: admit → (batch step) → tick and evict."""
    completed = self._step_batch() if self._arena_admit_phase() else 0
    with self._lock:
      arenas = [(k, a) for k, a in self._arenas.items() if a.live_slots()]
    for key, arena in arenas:
      completed += self._tick_arena(key, arena)
    return completed

  def _arena_admit_phase(self) -> bool:
    """Move queued closure requests into free arena slots in the policy's
    bucket order.  Returns True when the queue head is not closure traffic
    (the caller then runs one batch step).  Admission stops at a full
    arena: its slots free up at the next sweep, so no more requests leave
    the queue than there are slots."""
    while True:
      with self._lock:
        now = self._clock()
        key = self.scheduler.peek_bucket(now)
        if key is None:
          return False
        if key.kind != "closure":
          return True
        arena = self._arena_for_locked(key)
        free = arena.free_slots()
        if free <= 0:
          return False
        taken = self.scheduler.take_from(key, free, now=now)
        expired = self.scheduler.take_expired()
        if expired:
          self._expire_locked(expired)
        for r in taken:
          self.admission.on_dequeue(r)
          self._inflight.add(r.request_id)
          if key not in self._arenas_ticked:
            self._arena_cold.add(r.request_id)
          arena.admit(r, now=self._clock())

  def _tick_arena(self, key, arena) -> int:
    """One tick of one arena — the fused chunk launch and the eviction
    sweep.  A tick that raises fails every resident request and resets the
    arena (the reference's behaviour once its retry budget is spent)."""
    t0 = self._clock()
    try:
      arena.tick()
      evictions = arena.sweep()  # waits for the tick's device flags
    except Exception as e:  # noqa: BLE001 — the residents fail, serving goes on
      self._fail_requests(key, arena.reset(), e)
      return 0
    t1 = self._clock()
    with self._lock:
      self._batches += 1
      self._arenas_ticked.add(key)
      self.metrics.on_batch(key, host_s=0.0, device_s=t1 - t0, h2d_bytes=0)
    return self._finish_evictions(key, evictions)

  def _finish_evictions(self, key, evictions) -> int:
    """Turn evictions into results.  A NaN slot fails alone; its
    neighbours complete.  The estimator observes each request's measured
    iterations and its slot-seconds (admit → evict), the residency QoS
    predictions price, unless the slot lived through the arena's first
    (cold) tick."""
    completed = 0
    for ev in evictions:
      r, value = ev.request, ev.value
      if (self.validate_results and np.issubdtype(value.dtype, np.floating)
          and bool(np.isnan(value).any())):
        self._fail_requests(key, [r], NonFiniteResultError(
            bucket_label(key), [ev.slot]))
        continue
      res = MMOResult(value=value, extras={"iterations": int(ev.iterations)})
      now = self._clock()
      self.estimator.observe_iterations(key, [int(ev.iterations)])
      with self._lock:
        cold = r.request_id in self._arena_cold
        self._arena_cold.discard(r.request_id)
      if not cold:
        self.estimator.observe_batch(key, _ARENA, _LOCAL, 1, now - ev.admit_s)
      with self._lock:
        self._inflight.discard(r.request_id)
        self._records.append(RequestRecord(
            request_id=r.request_id, kind=r.kind, op=r.op, bucket=tuple(key),
            batch_size=1, arrival_s=r.arrival_s, scheduled_s=ev.admit_s,
            completed_s=now))
        self.admission.on_done(r)
        self.metrics.on_complete(key, queue_s=ev.admit_s - r.arrival_s,
                                 service_s=now - ev.admit_s)
        fut = self._pending.pop(r.request_id, None)
        if fut is not None:
          fut._fulfill(res)
        if not self._pending:
          self._idle.notify_all()
      completed += 1
    return completed

  def arena_stats(self) -> dict:
    """Per-arena slot statistics, keyed by bucket label."""
    with self._lock:
      arenas = dict(self._arenas)
    return {bucket_label(k): a.stats() for k, a in arenas.items()}

  def run_until_idle(self) -> int:
    """Drain the queue (and, in arena mode, every resident slot)
    synchronously; returns total requests completed."""
    total = 0
    while True:
      done = self.step()
      with self._lock:
        drained = (len(self.scheduler) == 0
                   and not self._arena_live_locked())
      if done == 0 and drained:
        return total
      total += done

  def _check_dropped(self, fut: MMOFuture):
    """Raise if the scheduler lost this request: still pending, but neither
    queued nor inside an executing batch or an arena slot — an engine
    bug."""
    rid = fut.request.request_id
    with self._lock:
      dropped = (rid in self._pending and rid not in self._inflight
                 and len(self.scheduler) == 0
                 and not self._arena_live_locked())
    if dropped:
      raise RuntimeError(
          f"request {rid} ({fut.request.kind}/{fut.request.op}) was "
          f"dropped: the queue drained without completing it — engine bug")

  def _drive(self, fut: MMOFuture, timeout: Optional[float]):
    """Future.result() plumbing: wait on the loop, or step synchronously."""
    deadline = None if timeout is None else time.perf_counter() + timeout
    while (self._thread is not None and self._thread.is_alive()
           and not fut.done()):
      self._check_dropped(fut)
      if deadline is not None and time.perf_counter() > deadline:
        return
      wait = 0.05 if deadline is None else max(
          0.0, min(0.05, deadline - time.perf_counter()))
      if fut._event.wait(wait):
        return
    while not fut.done():
      if deadline is not None and time.perf_counter() > deadline:
        return
      if self.step() == 0 and not fut.done():
        self._check_dropped(fut)
        wait = 0.005 if deadline is None else max(
            0.0, min(0.005, deadline - time.perf_counter()))
        fut._event.wait(wait)

  def prewarm(self, sample_reqs) -> int:
    """Build every (bucket, pow2-batch) executable the sample's buckets can
    produce, without executing anything — in arena mode, a closure bucket's
    three arena programs instead.  Returns #executables built; after it,
    traffic confined to those buckets causes zero cache misses."""
    with self._lock:
      min_bucket = self.scheduler.min_bucket
      max_batch = self.scheduler.max_batch
    seen = {request_bucket(req, min_bucket) for req in sample_reqs}
    before = self.cache.misses
    for key in seen:
      if self.mode == "arena" and key.kind == "closure":
        with self._lock:
          arena = self._arena_for_locked(key)
        arena.prewarm()
        continue
      rb = 1
      while True:
        self._build(key, rb, batching.abstract_batch(key, rb))
        if rb >= max_batch:
          break
        rb = self._batch_bucket(min(2 * rb, max_batch))
    return self.cache.misses - before

  # -- live metrics ----------------------------------------------------------

  def metrics_snapshot(self) -> dict:
    """Point-in-time QoS view (rolling-window per-bucket p50/p99 queue and
    service latency, counters, queue depth, admission state, estimator
    cells).  Safe from any thread while the serving loop runs: the gauges
    are read under the engine lock for one moment, then aggregated outside
    the serving path."""
    with self._lock:
      depth = len(self.scheduler)
      executing = len(self._inflight)
      adm = self.admission.snapshot()
    return self.metrics.snapshot(queue_depth=depth, executing=executing,
                                 admission=adm,
                                 estimator=self.estimator.snapshot())

  # -- background serving loop -----------------------------------------------

  def start(self):
    """Spawn the background serving thread (idempotent; re-arms submit
    after a stop())."""
    with self._lock:
      self._stopped = False
      if self._running:
        return
      self._running = True
    self._thread = threading.Thread(target=self._loop, name="mmo-serve",
                                    daemon=True)
    self._thread.start()

  def stop(self, *, drain: bool = True):
    """Stop the loop; with ``drain`` finish everything queued first (without
    a running loop, drain synchronously).  Later ``submit`` calls raise
    until ``start()`` is called again."""
    with self._lock:
      self._stopped = True
    if drain:
      if self._thread is not None and self._thread.is_alive():
        with self._idle:
          while self._pending and self._thread.is_alive():
            self._idle.wait(timeout=0.5)
      else:
        self.run_until_idle()
    with self._work:
      self._running = False
      self._work.notify_all()
    if self._thread is not None:
      self._thread.join()
      self._thread = None

  def _loop(self):
    if self.device.type == "cuda":
      torch.cuda.set_device(self.device)
    while True:
      with self._work:
        while (self._running and len(self.scheduler) == 0
               and not self._arena_live_locked()):
          self._work.wait()
        if not self._running:
          return
      self.step()

  # -- stats -----------------------------------------------------------------

  def stats(self) -> EngineStats:
    with self._lock:
      recs = list(self._records)
      batches = self._batches
      rejected, expired = self._rejected, self._expired
    lat = np.asarray([r.latency_s for r in recs], dtype=np.float64)
    return EngineStats(
        completed=len(recs),
        batches=batches,
        mean_batch=(len(recs) / batches) if batches else 0.0,
        latencies_s=lat,
        cache=self.cache.stats(),
        rejected=rejected,
        expired=expired,
    )

  def reset_stats(self):
    with self._lock:
      self._records.clear()
      self._batches = 0
      self._rejected = 0
      self._expired = 0
