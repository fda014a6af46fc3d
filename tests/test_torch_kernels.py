"""K1 (the SIMD² unit kernel) and its plain version against the reference.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the reference Pallas kernel run in interpret mode (as tests/test_kernels.py
runs it) for every ring except addnorm, which is held against the direct
Σ(a−b)² oracle ``addnorm_ref`` (the reference kernel uses the cancelling
‖a‖²−2ab+‖b‖² rewrite; see ROADMAP Queue 3).  Tolerances: bit-exact for the
min/max rings and orand in f32, rtol 1e-5 / atol 1e-4 for mma and addnorm
(summation order differs), 3e-2 for bf16 (the reference's own).

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""
import importlib
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.semiring import ALL_OPS  # noqa: E402
from repro.kernels import semiring_mmo as j_semiring_mmo  # noqa: E402
from repro.kernels.ref import semiring_mmo_ref as j_ref  # noqa: E402
from repro_torch.core import semiring as tsr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")

# the reference kernel sweep's shapes (tests/test_kernels.py)
MMO_SHAPES = [(128, 128, 128), (64, 200, 96), (13, 7, 5), (256, 384, 128),
              (1, 128, 1)]
EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")


def assert_parity(got, want, op, *, bf16=False):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  if bf16:
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
  elif op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _operands(op, shape, seed, batch=()):
  m, k, n = shape
  rng = np.random.default_rng(seed)
  a = rng.standard_normal(batch + (m, k)).astype(np.float32)
  b = rng.standard_normal(batch + (k, n)).astype(np.float32)
  c = rng.standard_normal(batch + (m, n)).astype(np.float32)
  if op == "orand":
    a, b, c = a > 0.8, b > 0.8, c > 1.5
  return a, b, c


def _reference(a, b, c, op, **kw):
  args = [jnp.asarray(x) for x in (a, b, c) if x is not None]
  if op == "addnorm":
    return np.asarray(j_ref(*args, op=op))
  return np.asarray(j_semiring_mmo(*args, op=op, interpret=True, **kw))


@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("shape", MMO_SHAPES)
def test_plain_matches_reference_kernel(op, shape):
  a, b, c = _operands(op, shape, seed=sum(shape) + ALL_OPS.index(op))
  got = ops.semiring_mmo(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(c), op=op)
  assert got.dtype == tsr.get(op).acc_dtype(torch.from_numpy(a).dtype)
  assert_parity(got.numpy(), _reference(a, b, c, op), op)


@pytest.mark.parametrize("op", ["mma", "minplus", "maxmin", "addnorm"])
def test_plain_bf16_matches_reference_kernel(op):
  rng = np.random.default_rng(5)
  a = jnp.asarray(rng.standard_normal((64, 96)), jnp.bfloat16)
  b = jnp.asarray(rng.standard_normal((96, 32)), jnp.bfloat16)
  want = _reference(a, b, None, op)
  ta = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
  tb = torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16)
  got = ops.semiring_mmo(ta, tb, op=op)
  assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
  assert_parity(got.float().numpy(), np.asarray(want, np.float32), op,
                bf16=True)


@pytest.mark.parametrize("op", ["mma", "minplus", "maxmin", "orand",
                                "addnorm"])
def test_plain_per_request_k_valid_matches_reference(op):
  """Ragged masked-K: lanes at/beyond each request's k_valid hold pads."""
  r, m, k, n = 3, 16, 64, 24
  kv = np.asarray([24, 40, 0], np.int32)
  rng = np.random.default_rng(7)
  a = rng.standard_normal((r, m, k)).astype(np.float32)
  b = rng.standard_normal((r, k, n)).astype(np.float32)
  pa, pb = tsr.contraction_pads(op)
  if op == "orand":
    a, b, pa, pb = a > 0.3, b > 0.3, False, False
  for i, kvi in enumerate(kv):
    a[i, :, kvi:] = pa
    b[i, kvi:, :] = pb
  got = ops.semiring_mmo(torch.from_numpy(a), torch.from_numpy(b), op=op,
                         k_valid=torch.from_numpy(kv)).numpy()
  # a request at k_valid=0 sees only pads: its ⊕-identity output is what
  # the full (unmasked) oracle gives too
  assert_parity(got, _reference(a, b, None, op), op)
  got0 = ops.semiring_mmo(torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                          op=op, k_valid=24).numpy()
  assert_parity(got0, _reference(a, b, None, op)[0], op)


def test_plain_batched_form_matches_reference():
  rng = np.random.default_rng(9)
  a = rng.standard_normal((3, 2, 16, 32)).astype(np.float32)
  b = rng.standard_normal((3, 2, 32, 24)).astype(np.float32)
  got = ops.semiring_mmo(torch.from_numpy(a), torch.from_numpy(b),
                         op="minplus").numpy()
  want = np.asarray(j_semiring_mmo(jnp.asarray(a), jnp.asarray(b),
                                   op="minplus", interpret=True))
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(40, 70, 50), (13, 7, 5)])
def test_addnorm_against_direct_oracle(shape):
  """addnorm is the ring's own Σ(a−b)²: held against both oracles."""
  a, b, c = _operands("addnorm", shape, seed=11)
  got = ops.semiring_mmo(torch.from_numpy(a), torch.from_numpy(b),
                         op="addnorm").numpy()
  np.testing.assert_allclose(
      got, tref.addnorm_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
      rtol=1e-5, atol=1e-4)
  np.testing.assert_allclose(
      got, np.asarray(j_ref(jnp.asarray(a), jnp.asarray(b), op="addnorm")),
      rtol=1e-5, atol=1e-4)


def test_addnorm_exact_at_large_coordinates():
  """Coordinates near 1e6: the direct form keeps f32 accuracy where the
  ‖a‖²−2ab+‖b‖² rewrite cancels away every significant digit."""
  rng = np.random.default_rng(3)
  a = (rng.standard_normal((7, 5)) + 1.0e6).astype(np.float32)
  b = (rng.standard_normal((5, 21)) + 1.0e6).astype(np.float32)
  exact = ((a.astype(np.float64)[:, :, None]
            - b.astype(np.float64)[None, :, :]) ** 2).sum(axis=1)
  got = ops.semiring_mmo(torch.from_numpy(a), torch.from_numpy(b),
                         op="addnorm").numpy()
  np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)


def test_ref_oracle_matches_reference_oracle():
  for op in ALL_OPS:
    a, b, c = _operands(op, (9, 11, 6), seed=2)
    got = tref.semiring_mmo_ref(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(c), op=op).numpy()
    want = np.asarray(j_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                            op=op))
    assert_parity(got, want, op)


@pytest.mark.parametrize("bad", ["dtype", "shape", "kv", "c"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
  a = torch.zeros(2, 4, 3)
  b = torch.zeros(2, 3, 5)
  kw = {}
  if bad == "dtype":
    a, b = a.double(), b.double()
  elif bad == "shape":
    b = torch.zeros(2, 4, 5)
  elif bad == "kv":
    kw["k_valid"] = torch.zeros(2, dtype=torch.int64)
  else:
    kw["c"] = torch.zeros(2, 4, 5, dtype=torch.float64)
  with pytest.raises((TypeError, ValueError)):
    sm.semiring_mmo(a, b, op="minplus", **kw)


def test_cpu_calls_do_not_count_launches():
  before = sm.semiring_mmo.launches
  sm.semiring_mmo(torch.zeros(1, 4, 3), torch.zeros(1, 3, 5), op="minplus")
  assert sm.semiring_mmo.launches == before
