"""The reference's kernel property (tests/test_property.py's random op ×
shape × dtype sweep) on the card: K1 against its plain version.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_property_cuda.py

Tolerances are the reference's: 1e-4 in f32 and for orand, 5e-2 in bf16.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import ALL_OPS  # noqa: E402
from repro_torch.kernels import semiring_mmo  # noqa: E402

sm = importlib.import_module("repro_torch.kernels.semiring_mmo")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")  # hypothesis runs many inputs per call
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


@settings(max_examples=15, deadline=None)
@given(data=st.data())
def test_kernel_random_shapes(cuda, data):
  """K1 at a random op × shape × dtype: one launch, its plain version's
  result."""
  op = data.draw(st.sampled_from(list(ALL_OPS)))
  m = data.draw(st.integers(1, 40))
  k = data.draw(st.integers(1, 40))
  n = data.draw(st.integers(1, 40))
  f32 = data.draw(st.booleans())
  rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
  a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
  b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda)
  if op == "orand":
    a, b = a > 0.7, b > 0.7
  elif not f32:
    a, b = a.bfloat16(), b.bfloat16()
  before = sm.semiring_mmo.launches
  got = semiring_mmo(a, b, op=op)
  torch.cuda.synchronize()
  assert sm.semiring_mmo.launches == before + 1
  want = sm.semiring_mmo_plain(a[None], b[None], op=op)[0]
  tol = 1e-4 if (f32 or op == "orand") else 5e-2
  np.testing.assert_allclose(got.double().cpu().numpy(),
                             want.double().cpu().numpy(), rtol=tol, atol=tol)
