"""The autotuner and ``backend="auto"`` serving, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_tuning_cuda.py

The measured times come from CUDA events (``tuning/autotune.py``); the
auto engine must return what the fixed arms return: bit-identical for the
min/max rings and orand (closure iteration counts included), rtol 1e-5 /
atol 1e-4 for KNN distances with identical indices when both run one arm.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_mmo as tserve  # noqa: E402
from repro_torch.apps import graphs  # noqa: E402
from repro_torch.serve_mmo.scheduler import request_bucket  # noqa: E402
from repro_torch.tuning import autotune, tune_for_requests  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


@pytest.mark.parametrize("op,dtype", [("minplus", "float32"),
                                      ("mma", "float32"), ("orand", "bool")])
def test_measure_point_on_the_kernel_arm_is_finite(cuda, op, dtype):
  s = autotune.measure_point(op, (256, 256, 256), dtype, "pallas", (),
                             device=cuda, iters=3, warmup=1)
  assert 0.0 < s < 1.0 and math.isfinite(s)


@pytest.mark.parametrize("g", [2, 8])
def test_measure_megakernel_point_is_finite(cuda, g):
  s = autotune.measure_megakernel_point("minplus", (128, 128, 128),
                                        "float32", (g,), device=cuda,
                                        iters=3, warmup=1)
  assert 0.0 < s < 1.0 and math.isfinite(s)


def _stream():
  rng = np.random.default_rng(3)
  reqs = []
  for i in range(12):
    n = int(rng.integers(20, 130))
    kind = ("apsp", "reach", "knn", "mmo")[i % 4]
    if kind == "apsp":
      reqs.append(("apsp", graphs.weighted_digraph(n, 0.1, seed=i)))
    elif kind == "reach":
      reqs.append(("reach", graphs.boolean_digraph(n, 0.05, seed=i)))
    elif kind == "knn":
      ref, qry = graphs.knn_points(4 * n, n, 16, seed=i)
      reqs.append(("knn", (qry, ref)))
    else:
      a = rng.standard_normal((n, n)).astype(np.float32)
      reqs.append(("mmo", (a, a.T.copy())))
  return reqs


def _request(kind, x):
  if kind == "apsp":
    return tserve.apsp_request(x)
  if kind == "reach":
    return tserve.reachability_request(x)
  if kind == "knn":
    return tserve.knn_request(*x, k=8)
  return tserve.mmo_request(*x, op="minplus")


def test_auto_engine_returns_the_fixed_arms_results(cuda):
  stream = _stream()
  table = tune_for_requests([_request(k, x) for k, x in stream],
                            device=cuda, iters=2, warmup=1)
  assert table.counts()["measured"] > 0
  eng = tserve.MMOEngine(backend="auto", cost_table=table, adaptive=True,
                         device=cuda)
  futs = [eng.submit(_request(k, x)) for k, x in stream]
  eng.run_until_idle()
  fixed = {b: tserve.MMOEngine(backend=b, device=cuda)
           for b, _ in set(eng._decisions.values())}
  for (kind, x), fut in zip(stream, futs):
    got = fut.result()
    backend, _ = eng._decisions[request_bucket(fut.request)]
    want = fixed[backend].submit(_request(kind, x)).result()
    if kind == "knn":
      np.testing.assert_array_equal(got.extras["indices"],
                                    want.extras["indices"])
      np.testing.assert_allclose(got.value, want.value, rtol=1e-5, atol=1e-4)
    else:
      np.testing.assert_array_equal(got.value, want.value)
      assert got.extras == want.extras
