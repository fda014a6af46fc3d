"""The port's sparse SIMD² module against the reference's.

2:4 structured sparsity: ``prune_24`` and ``densify_24`` give the
reference's values and indices exactly, and ``mmo_sparse24`` its result
(bit-exact on the min/max rings and orand, rtol 1e-5 / atol 1e-4 on mma)
and the dense contraction of the densified operand.  Semiring-aware CSR:
the cases of tests/test_sparse.py on every storable ring — seeds validated
against the registry, ``csr_spmm`` equal to the dense contraction, addnorm
refused with the reference's message.  The port's CSR arm computes in
float64: exactly the dense float64 contraction on the min/max rings and
orand; the reference's runs its jnp ops in f32, so it is held to that
within atol 1e-5, as tests/test_sparse.py holds it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import sparse as jsp  # noqa: E402
from repro_torch.core import semiring as sr_mod  # noqa: E402
from repro_torch.core import sparse  # noqa: E402
from repro_torch.core.mmo import mmo, mmo_reference  # noqa: E402

STORABLE = [op for op in sr_mod.ALL_OPS if op != "addnorm"]
EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")


def _sample(op, rng, shape):
  sr = sr_mod.get(op)
  if sr.boolean:
    return rng.random(shape) < 0.5
  if op in ("minmul", "maxmul", "maxmin"):
    return rng.uniform(0.25, 2.0, shape)  # positive operating domain
  return rng.uniform(-1.0, 1.0, shape)


def _parity(got, want, op):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  if op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_prune_24_and_densify_match_the_reference():
  rng = np.random.default_rng(1)
  a = rng.standard_normal((9, 16)).astype(np.float32)
  a[0, :4] = [1.0, -1.0, 1.0, 0.5]  # a tie: the lower index is kept
  vals, idx = sparse.prune_24(torch.from_numpy(a))
  jv, ji = jsp.prune_24(jnp.asarray(a))
  assert idx.dtype == torch.int32
  np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
  np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
  np.testing.assert_array_equal(
      sparse.densify_24(vals, idx, 16).numpy(),
      np.asarray(jsp.densify_24(jv, ji, 16)))
  with pytest.raises(ValueError, match="divisible by 4"):
    sparse.prune_24(torch.zeros(2, 6))


@pytest.mark.parametrize("op", sr_mod.ALL_OPS)
def test_mmo_sparse24_matches_the_reference_and_the_dense_op(op):
  rng = np.random.default_rng(2)
  a = rng.standard_normal((12, 32)).astype(np.float32)
  b = rng.standard_normal((32, 10)).astype(np.float32)
  c = rng.standard_normal((12, 10)).astype(np.float32)
  if op == "orand":
    b, c = b > 0.5, c > 1.5
  vals, idx = sparse.prune_24(torch.from_numpy(a))
  tb, tc = torch.from_numpy(b), torch.from_numpy(c)
  if op == "orand":
    vals = vals > 0.5
  got = sparse.mmo_sparse24(vals, idx, tb, tc, op=op)
  jv, ji = jsp.prune_24(jnp.asarray(a))
  if op == "orand":
    jv = jv > 0.5
  want = jsp.mmo_sparse24(jv, ji, jnp.asarray(b), jnp.asarray(c), op=op)
  assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype)
  _parity(got, want, op)
  if op in ("mma", "orand"):  # pruned lanes are 0: the ⊗-annihilator
    dense = mmo(sparse.densify_24(vals, idx, 32), tb, tc, op=op,
                backend="vector")
    _parity(got, dense, op)


@pytest.mark.parametrize("op", STORABLE)
def test_csr_seed_validates(op):
  sparse.validate_csr_seed(op)  # must not raise on the shipped table


@pytest.mark.parametrize("op", STORABLE)
def test_csr_spmm_matches_dense(op):
  rng = np.random.default_rng(7)
  sr = sr_mod.get(op)
  absent = sparse.csr_absent_value(op)
  a = _sample(op, rng, (6, 8))
  b = _sample(op, rng, (8, 5))
  mask = rng.random((6, 8)) < 0.4
  dt = bool if sr.boolean else np.float64
  a = np.asarray(a, dt)
  a[mask] = absent
  a[3, :] = absent  # one fully-absent row
  indptr, indices, data = sparse.to_csr(a, op=op)
  want_csr = jsp.to_csr(a, op=op)
  for got_part, want_part in zip((indptr, indices, data), want_csr):
    np.testing.assert_array_equal(got_part, want_part)
  assert len(data) == np.count_nonzero(a != np.asarray(absent, dt))
  got = sparse.csr_spmm(indptr, indices, data, np.asarray(b, dt), op=op)
  dense = mmo_reference(torch.from_numpy(a), torch.from_numpy(
      np.asarray(b, dt)), op=op).numpy()
  _parity(got, dense, op)
  ref = jsp.csr_spmm(indptr, indices, data, np.asarray(b, dt), op=op)
  np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                             atol=1e-5)


def test_addnorm_csr_refused():
  with pytest.raises(ValueError, match="annihilator"):
    sparse.to_csr(np.zeros((2, 2)), op="addnorm")
  with pytest.raises(ValueError, match="annihilator"):
    sparse.csr_absent_value("addnorm")


@pytest.mark.parametrize("op,bad", [("mma", 1.0), ("minplus", 0.0),
                                    ("maxmin", float("inf"))])
def test_bad_seed_rejected(monkeypatch, op, bad):
  """An absent value that its ring's ⊗ does not absorb is refused."""
  monkeypatch.setitem(sparse._ABSENT, op, bad)
  with pytest.raises(ValueError, match="not absorbed"):
    sparse.validate_csr_seed(op)


def test_nan_seed_rejected(monkeypatch):
  monkeypatch.setitem(sparse._ABSENT, "minmul", 0.0)  # 0 · inf sample
  with pytest.raises(ValueError, match="poisons|not absorbed"):
    sparse.validate_csr_seed("minmul", samples=[float("inf"), 1.0])


def test_mma_default_matches_legacy_path():
  rng = np.random.default_rng(3)
  a = rng.standard_normal((5, 7))
  a[rng.random((5, 7)) < 0.5] = 0.0
  b = rng.standard_normal((7, 4))
  csr = sparse.to_csr(a)          # default op="mma"
  np.testing.assert_allclose(sparse.csr_spmm_np(*csr, b),
                             sparse.csr_spmm(*csr, b, op="mma"), rtol=1e-12,
                             atol=1e-12)
  np.testing.assert_array_equal(sparse.csr_spmm_np(*csr, b),
                                jsp.csr_spmm_np(*csr, b))
