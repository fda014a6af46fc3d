"""MMO serving engine — shape-bucketed batching for semiring workloads.

Counterpart of ``repro.serve_mmo`` with the FIFO policy, in batch and arena
mode:

  api.py        — problem requests (apsp / knn / reachability / raw mmo) and
                  result futures,
  scheduler.py  — request queue bucketed by (kind, op, padded shape, dtype,
                  static params); bucket picking delegates to a policy,
  policy.py     — scheduling policies (FIFO),
  batching.py   — pad-and-stack micro-batcher: one batch function per bucket
                  executes a whole request batch on the device (per-request
                  convergence masks for closures),
  arena.py      — device-resident slot buffer for closure buckets: admit
                  between fused K2 ticks, evict on convergence,
  cache.py      — executable cache keyed by (bucket, batch, backend),
  engine.py     — submit()/futures, synchronous step() or a background
                  serving loop, per-request latency stats, NaN validation;
                  ``mode="arena"`` serves closures from arenas.

Quickstart::

    from repro_torch.serve_mmo import MMOEngine, apsp_request

    eng = MMOEngine(backend="pallas", max_batch=8)   # device="cuda"
    futs = [eng.submit(apsp_request(w)) for w in weight_matrices]
    eng.run_until_idle()
    dist = futs[0].result().value
"""
from repro_torch.serve_mmo.api import (DeadlineExceededError, MMOFuture,
                                       MMOResult, NonFiniteResultError,
                                       ProblemRequest, RejectedError,
                                       apsp_request, closure_request,
                                       knn_request, mmo_request,
                                       reachability_request)
from repro_torch.serve_mmo.arena import Eviction, RequestArena
from repro_torch.serve_mmo.cache import ExecutableCache
from repro_torch.serve_mmo.engine import EngineStats, MMOEngine, bucket_label
from repro_torch.serve_mmo.policy import (FifoPolicy, QueueEntry,
                                          SchedulingPolicy, make_policy)
from repro_torch.serve_mmo.scheduler import (BucketKey, BucketScheduler,
                                             FifoBucketScheduler, bucket_dim,
                                             contract_shape, request_bucket)

# The reference's public names that are ported.  QueueEntry, bucket_dim,
# contract_shape and request_bucket stay importable from here but are not
# in the reference's __all__.
__all__ = [
    "ProblemRequest",
    "MMOFuture",
    "MMOResult",
    "MMOEngine",
    "EngineStats",
    "RequestArena",
    "Eviction",
    "ExecutableCache",
    "BucketKey",
    "BucketScheduler",
    "FifoBucketScheduler",
    "SchedulingPolicy",
    "FifoPolicy",
    "make_policy",
    "bucket_label",
    "NonFiniteResultError",
    "RejectedError",
    "DeadlineExceededError",
    "mmo_request",
    "closure_request",
    "apsp_request",
    "reachability_request",
    "knn_request",
]
