"""The port's ring registry against the reference's (repro.core.semiring).

Identities, pads, dtype rules and flags must agree entry by entry, and the
torch ⊕/⊗ must agree element by element with the jnp ops over the
adversarial float sets of repro.analysis.laws (±inf, NaN, ±0, denormals).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analysis.laws import LAW_DOMAINS  # noqa: E402
from repro.core import semiring as jsr  # noqa: E402
from repro_torch.core import semiring as tsr  # noqa: E402


def _same(x, y) -> bool:
  """Equal values and equal NaN positions."""
  x, y = np.asarray(x), np.asarray(y)
  if x.dtype == bool or y.dtype == bool:
    return np.array_equal(x, y)
  return np.array_equal(x, y, equal_nan=True)


def test_registry_order_matches():
  assert tsr.ALL_OPS == jsr.ALL_OPS


@pytest.mark.parametrize("op", jsr.ALL_OPS)
def test_registry_entry_matches_reference(op):
  j, t = jsr.get(op), tsr.get(op)
  assert t.name == j.name
  assert _same(t.oplus_identity, j.oplus_identity)
  assert t.otimes_identity == j.otimes_identity
  assert (t.boolean, t.mxu_rewrite, t.accumulate_f32) == (
      j.boolean, j.mxu_rewrite, j.accumulate_f32)
  assert tsr.contraction_pads(op) == jsr.contraction_pads(op)
  assert tsr.get(t) is t


@pytest.mark.parametrize("op", jsr.ALL_OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_acc_dtype_matches_reference(op, dtype):
  want = jsr.get(op).acc_dtype(jnp.dtype(dtype))
  got = tsr.get(op).acc_dtype(getattr(torch, dtype))
  assert str(got).removeprefix("torch.") == str(want)


@pytest.mark.parametrize("op", jsr.ALL_OPS)
def test_identity_like(op):
  t = tsr.get(op)
  x = t.identity_like((2, 3), torch.float32)
  want = np.asarray(jsr.get(op).identity_like((2, 3), jnp.float32))
  assert _same(x.numpy(), want)


@pytest.mark.parametrize("op", jsr.ALL_OPS)
def test_pads_are_oplus_identity_under_otimes(op):
  t = tsr.get(op)
  pa, pb = tsr.contraction_pads(op)
  dtype = torch.bool if t.boolean else torch.float32
  prod = t.otimes(torch.tensor(pa, dtype=dtype), torch.tensor(pb, dtype=dtype))
  ident = t.identity_like((), dtype)
  assert _same(prod.numpy(), ident.numpy())


@pytest.mark.parametrize("op", jsr.ALL_OPS)
def test_elementwise_ops_match_jnp_on_adversarial_floats(op):
  """⊕ and ⊗ over every pair of the ring's law domain, plus NaN."""
  j, t = jsr.get(op), tsr.get(op)
  if t.boolean:
    vals = np.asarray(LAW_DOMAINS[op], dtype=bool)
  else:
    vals = np.asarray(LAW_DOMAINS[op] + [float("nan"), float("-inf"),
                                         float("inf")], dtype=np.float32)
  x, y = (np.asarray(v) for v in zip(*itertools.product(vals, vals)))
  for jop, top in ((j.oplus, t.oplus), (j.otimes, t.otimes)):
    want = np.asarray(jop(jnp.asarray(x), jnp.asarray(y)))
    got = top(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.dtype == want.dtype
    assert _same(got, want), (op, x[~np.isclose(got, want, equal_nan=True)])


@pytest.mark.parametrize("op", jsr.ALL_OPS)
def test_oplus_reduce_matches_jnp(op):
  rng = np.random.default_rng(3)
  x = rng.standard_normal((5, 7, 4)).astype(np.float32)
  x[0, 2, 1] = np.inf
  x[1, 3, 2] = -np.inf
  x[2, 4, 3] = np.nan
  if jsr.get(op).boolean:
    x = x > 0.5
  for axis in (0, 1, 2):
    want = np.asarray(jsr.oplus_reduce(op, jnp.asarray(x), axis=axis))
    got = tsr.oplus_reduce(op, torch.from_numpy(x), dim=axis).numpy()
    if op in ("mma", "addnorm"):
      np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
      assert _same(got, want)


def test_unknown_op_raises():
  with pytest.raises(ValueError, match="unknown SIMD² op"):
    tsr.get("maxmax")
