"""The port's ``mmo`` / ``mmo_batched`` against the reference's, arm by arm.

Arms map 1:1: 'xla' (matmul rewrites + blocked vector), 'vector' (blocked
broadcast-reduce) and 'pallas' (the SIMD² unit kernel; its plain version on
the CPU, the reference's Pallas kernel in interpret mode).  Bit-exact on the
min/max rings and orand; rtol 1e-5 / atol 1e-4 on mma and addnorm.
"""
import importlib
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.mmo import mmo as j_mmo  # noqa: E402
from repro.core.mmo import mmo_batched as j_mmo_batched  # noqa: E402
from repro.core.mmo import mmo_reference as j_mmo_reference  # noqa: E402
from repro.core.semiring import ALL_OPS  # noqa: E402
tmmo = importlib.import_module("repro_torch.core.mmo")
from repro_torch.core import semiring as tsr  # noqa: E402

EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")
BACKENDS = ("xla", "vector", "pallas")


def assert_parity(got, want, op):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _operands(op, batch, m, k, n, seed):
  rng = np.random.default_rng(seed)
  a = rng.standard_normal(batch + (m, k)).astype(np.float32)
  b = rng.standard_normal(batch + (k, n)).astype(np.float32)
  c = rng.standard_normal(batch + (m, n)).astype(np.float32)
  if op == "orand":
    a, b, c = a > 0.7, b > 0.7, c > 1.5
  return a, b, c


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ALL_OPS)
def test_mmo_matches_reference(backend, op):
  a, b, c = _operands(op, (), 24, 40, 16, seed=ALL_OPS.index(op))
  want = j_mmo(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), op=op,
               backend=backend)
  got = tmmo.mmo(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c), op=op, backend=backend)
  assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype)
  assert_parity(got.numpy(), want, op)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["mma", "minplus", "maxmul", "orand",
                                "addnorm"])
def test_mmo_batched_ragged_matches_reference(backend, op):
  """Per-request live K with pads past it; one request frozen at 0."""
  r, m, k, n = 3, 12, 40, 9
  kv = np.asarray([40, 17, 0], np.int32)
  a, b, c = _operands(op, (r,), m, k, n, seed=13)
  pa, pb = tsr.contraction_pads(op)
  if op == "orand":
    pa = pb = False
  for i, kvi in enumerate(kv):
    a[i, :, kvi:] = pa
    b[i, kvi:, :] = pb
  want = j_mmo_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                       op=op, backend=backend, k_valid=jnp.asarray(kv))
  got = tmmo.mmo_batched(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(c), op=op, backend=backend,
                         k_valid=torch.from_numpy(kv))
  assert_parity(got.numpy(), want, op)


@pytest.mark.parametrize("backend", ["xla", "vector"])
def test_vector_block_config_matches_reference(backend):
  a, b, c = _operands("minplus", (2,), 10, 37, 6, seed=1)
  want = j_mmo(jnp.asarray(a), jnp.asarray(b), op="minplus",
               backend=backend, block=(8,))
  got = tmmo.mmo(torch.from_numpy(a), torch.from_numpy(b), op="minplus",
                 backend=backend, block=(8,))
  assert_parity(got.numpy(), want, "minplus")


def test_mmo_reference_oracle_matches():
  for op in ALL_OPS:
    a, b, c = _operands(op, (), 7, 9, 5, seed=4)
    want = j_mmo_reference(jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(c), op=op)
    got = tmmo.mmo_reference(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(c), op=op)
    assert_parity(got.numpy(), want, op)


def test_megakernel_refused_for_single_contractions():
  x = torch.zeros(4, 4)
  with pytest.raises(ValueError, match="megakernel"):
    tmmo.mmo(x, x, op="minplus", backend="megakernel")


def test_auto_raises_until_tuning_is_ported():
  """Tuning is ported: 'auto' resolves through the cost table ('xla' with
  none) instead of raising."""
  from repro_torch.tuning import CostTable, use_cost_table
  x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
  with use_cost_table(None):
    got = tmmo.mmo(x, x, op="minplus", backend="auto")
  assert torch.equal(got, tmmo.mmo(x, x, op="minplus", backend="xla"))
  table = CostTable(device="test")
  table.record("minplus", (4, 4, 4), "float32", "pallas", (), 1e-9)
  with use_cost_table(table):
    got = tmmo.mmo(x, x, op="minplus", backend="auto")
  assert torch.equal(got, tmmo.mmo(x, x, op="minplus", backend="pallas"))


def test_kernel_arm_takes_no_block_config():
  x = torch.zeros(4, 4)
  with pytest.raises(NotImplementedError, match="shape rule"):
    tmmo.mmo(x, x, op="minplus", backend="pallas", block=(128, 128, 128))


@pytest.mark.parametrize("a_shape, b_shape, c_shape", [
    ((3,), (3, 4), None),
    ((2, 3), (4, 5), None),
    ((2, 3), (3, 5), (2, 4)),
])
def test_shape_checks(a_shape, b_shape, c_shape):
  c = None if c_shape is None else torch.zeros(c_shape)
  with pytest.raises(ValueError):
    tmmo.mmo(torch.zeros(a_shape), torch.zeros(b_shape), c, op="mma",
             backend="vector")


@pytest.mark.parametrize("a_shape, b_shape, c_shape", [
    ((2, 3), (2, 3, 4), None),
    ((2, 2, 3), (3, 3, 4), None),
    ((2, 2, 3), (2, 3, 4), (3, 2, 4)),
    ((2, 2, 3), (2, 3, 4), (2, 4)),
])
def test_mmo_batched_request_axis_checks(a_shape, b_shape, c_shape):
  c = None if c_shape is None else torch.zeros(c_shape)
  with pytest.raises(ValueError):
    tmmo.mmo_batched(torch.zeros(a_shape), torch.zeros(b_shape), c,
                     op="mma", backend="vector")
