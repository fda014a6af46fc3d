"""Recovery around K1 and K2, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_resilience_cuda.py

A retried, bisected or re-dispatched request must return what the
fault-free 'pallas' engine returns, bit for bit (minplus; iteration counts
included), and the K1/K2 launch counters say which kernel served it.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.kernels import closure_megakernel as mk  # noqa: E402

pytestmark = pytest.mark.cuda
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")


class _Clock:
  """A clock the test moves: breaker cooldowns without sleeping."""

  def __init__(self):
    self.t = 0.0

  def __call__(self):
    return self.t


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return "cuda"


def _reqs(count=4, n=96):
  return [tserve.apsp_request(graphs.weighted_digraph(n - 3 * i, 0.1,
                                                      seed=i))
          for i in range(count)]


def _serve(eng, reqs):
  futs = [eng.submit(r) for r in reqs]
  eng.run_until_idle()
  return futs


def _want(cuda, reqs):
  eng = tserve.MMOEngine(backend="pallas", device=cuda)
  return [f.result() for f in _serve(eng, reqs)]


def _launches(fn):
  sm.semiring_mmo.launches = 0
  mk.fixpoint_chunk.launches = 0
  fn()
  return sm.semiring_mmo.launches, mk.fixpoint_chunk.launches


def _same(got, want):
  return (np.array_equal(got.value, want.value)
          and got.extras == want.extras)


def test_transient_fault_on_k1_is_ridden_out(cuda):
  reqs = _reqs()
  want = _want(cuda, reqs)
  inj = tserve.FaultInjector([tserve.FaultRule(
      point="execute", mode="transient", count=1, backend="pallas")])
  eng = tserve.MMOEngine(backend="pallas", device=cuda, faults=inj,
                         retry_backoff_s=0.0)
  futs = []
  k1, k2 = _launches(lambda: futs.extend(_serve(eng, reqs)))
  assert k1 > 0 and k2 == 0
  assert all(_same(f.result(), w) for f, w in zip(futs, want))
  assert eng.metrics_snapshot()["counters"]["retries"] == 1


def test_poisoned_request_fails_alone_on_k1(cuda):
  reqs = _reqs(8)
  want = _want(cuda, reqs)
  inj = tserve.FaultInjector()
  eng = tserve.MMOEngine(backend="pallas", device=cuda, faults=inj,
                         retry_backoff_s=0.0, breaker_threshold=None)
  futs = [eng.submit(r) for r in reqs]
  inj.arm(tserve.FaultRule(point="nonfinite",
                           request_ids={futs[2].request.request_id}))
  assert eng.run_until_idle() == 7
  with pytest.raises(tserve.NonFiniteResultError):
    futs[2].result()
  assert all(_same(f.result(), w)
             for i, (f, w) in enumerate(zip(futs, want)) if i != 2)


def test_breaker_moves_k1_traffic_to_k2_and_back(cuda):
  reqs = _reqs(2)
  want = _want(cuda, reqs)
  clock = _Clock()
  inj = tserve.FaultInjector([tserve.FaultRule(point="execute",
                                               backend="pallas")])
  eng = tserve.MMOEngine(backend="pallas", device=cuda, faults=inj,
                         fallback_backends=("megakernel",),
                         breaker_threshold=2, transient_retries=2,
                         retry_backoff_s=0.0, breaker_probe_s=1.0,
                         clock=clock)
  futs = []
  k1, k2 = _launches(lambda: futs.extend(_serve(eng, reqs)))
  assert (k1, k2 > 0) == (0, True)
  assert all(_same(f.result(), w) for f, w in zip(futs, want))
  assert eng.resilience.open_arms()[0]["backend"] == "pallas"
  inj.clear()
  clock.t += 2.0
  futs = []
  k1, k2 = _launches(lambda: futs.extend(_serve(eng, reqs)))
  assert k1 > 0 and k2 == 0
  assert all(_same(f.result(), w) for f, w in zip(futs, want))
  assert eng.resilience.open_arms() == []


def test_watchdog_fails_a_stalled_batch_and_the_next_completes(cuda):
  reqs = _reqs()
  want = _want(cuda, reqs)
  inj = tserve.FaultInjector([tserve.FaultRule(
      point="slow", mode="transient", count=1, delay_s=1.0)])
  eng = tserve.MMOEngine(backend="pallas", device=cuda, faults=inj,
                         watchdog_s=0.2, transient_retries=0, bisect=False,
                         breaker_threshold=None)
  futs = _serve(eng, reqs)
  for f in futs:
    with pytest.raises(tserve.BatchTimeoutError):
      f.result()
  futs = _serve(eng, reqs)
  assert all(_same(f.result(), w) for f, w in zip(futs, want))
  assert eng.join_abandoned(timeout=30.0) == 0


def test_arena_nan_slot_fails_alone_on_k2(cuda):
  reqs = [tserve.apsp_request(graphs.weighted_digraph(60 + i, 0.1, seed=i),
                              algorithm="bellman_ford") for i in range(3)]
  want = _want(cuda, reqs)
  inj = tserve.FaultInjector([tserve.FaultRule(
      point="execute", backend="arena", mode="transient", count=1)])
  eng = tserve.MMOEngine(mode="arena", arena_capacity=4, arena_g=4,
                         device=cuda, faults=inj, retry_backoff_s=0.0)
  futs = [eng.submit(r) for r in reqs]
  inj.arm(tserve.FaultRule(point="nonfinite", backend="arena",
                           request_ids={futs[1].request.request_id}))
  k1, k2 = _launches(eng.run_until_idle)
  assert k1 == 0 and k2 > 0
  with pytest.raises(tserve.NonFiniteResultError):
    futs[1].result()
  assert _same(futs[0].result(), want[0]) and _same(futs[2].result(), want[2])
  assert eng.metrics_snapshot()["counters"]["retries"] >= 1
