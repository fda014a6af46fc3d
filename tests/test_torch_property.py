"""The reference's hypothesis properties (tests/test_property.py) on the
port's algebra, closures, checkpoints and K1.

Each property keeps the reference's strategy, ``max_examples`` and
``deadline=None``; the draws go through the port's functions instead:
the k-split invariance of ``mmo_reference`` under ⊕, the 'vector' and
'xla' arms' agreement, ⊕'s monoid laws, a closure's idempotence, the
checkpoint round trip, and K1 at random op × shape × dtype — here its
wrapper on CPU tensors, i.e. its plain version, against the unblocked
oracle (``kernels.ref.semiring_mmo_ref``); the kernel itself on the card
in tests/test_torch_property_cuda.py.  Tolerances are the reference's.

``hypothesis`` is an optional test dependency (see pyproject.toml); the
module skips cleanly when it is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import (ALL_OPS, get_semiring, mmo,  # noqa: E402
                              mmo_reference)
from repro_torch.kernels import semiring_mmo  # noqa: E402
from repro_torch.kernels.ref import semiring_mmo_ref  # noqa: E402

_dims = st.integers(min_value=1, max_value=12)
_ops = st.sampled_from([o for o in ALL_OPS if o != "orand"])
_vals = st.integers(min_value=-4, max_value=4)  # small ints: exact float math


def _mat(draw, m, n, els):
  return np.array(draw(st.lists(st.lists(els, min_size=n, max_size=n),
                                min_size=m, max_size=m)), dtype=np.float32)


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x))


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_k_split_invariance(data):
  """⊕ over a split contraction equals the full contraction:
  mmo(A,B) == mmo(A1,B1) ⊕ mmo(A2,B2) — the invariant every distributed
  schedule (kspan/SUMMA/ring) relies on."""
  op = data.draw(_ops)
  m, k, n = data.draw(_dims), data.draw(st.integers(2, 12)), data.draw(_dims)
  a = _mat(data.draw, m, k, _vals)
  b = _mat(data.draw, k, n, _vals)
  sr = get_semiring(op)
  cut = data.draw(st.integers(1, k - 1))
  full = mmo_reference(_t(a), _t(b), op=op)
  part = sr.oplus(mmo_reference(_t(a[:, :cut]), _t(b[:cut]), op=op),
                  mmo_reference(_t(a[:, cut:]), _t(b[cut:]), op=op))
  np.testing.assert_allclose(full.numpy(), part.numpy(), atol=1e-4)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_backend_equivalence(data):
  op = data.draw(st.sampled_from(list(ALL_OPS)))
  m, k, n = data.draw(_dims), data.draw(_dims), data.draw(_dims)
  a = _mat(data.draw, m, k, _vals)
  b = _mat(data.draw, k, n, _vals)
  if op == "orand":
    a, b = a > 0, b > 0
  v = mmo(_t(a), _t(b), op=op, backend="vector", block_k=3)
  x = mmo(_t(a), _t(b), op=op, backend="xla")
  np.testing.assert_allclose(v.double().numpy(), x.double().numpy(),
                             atol=1e-4)


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_oplus_monoid_laws(data):
  """⊕ associative + commutative with the declared identity (on the values
  each ring actually operates over)."""
  op = data.draw(st.sampled_from(list(ALL_OPS)))
  sr = get_semiring(op)
  els = st.booleans() if sr.boolean else _vals
  x, y, z = (np.array(data.draw(st.lists(els, min_size=4, max_size=4)))
             for _ in range(3))
  if not sr.boolean:
    x, y, z = (v.astype(np.float32) for v in (x, y, z))
  xt, yt, zt = _t(x), _t(y), _t(z)
  np.testing.assert_array_equal(sr.oplus(sr.oplus(xt, yt), zt).numpy(),
                                sr.oplus(xt, sr.oplus(yt, zt)).numpy())
  np.testing.assert_array_equal(sr.oplus(xt, yt).numpy(),
                                sr.oplus(yt, xt).numpy())
  ident = sr.identity_like(x.shape, xt.dtype)
  np.testing.assert_array_equal(sr.oplus(xt, ident).numpy(), x)


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_closure_idempotent(data):
  """A closure is a fixed point: closing the closure changes nothing."""
  from repro_torch.core import leyzorek_closure, prepare_adjacency
  op = data.draw(st.sampled_from(["minplus", "maxmin", "minmax"]))
  n = data.draw(st.integers(2, 8))
  w = _mat(data.draw, n, n, st.integers(1, 9))
  adj = prepare_adjacency(_t(w), op=op)
  closed, _ = leyzorek_closure(adj, op=op)
  again, _ = leyzorek_closure(closed, op=op)
  np.testing.assert_allclose(closed.numpy(), again.numpy(), atol=1e-5)


@settings(max_examples=20, deadline=None)
@given(st.data())
def test_checkpoint_roundtrip_pytree(data):
  """save→restore is the identity on arbitrary nested dict trees."""
  import tempfile
  from repro_torch.train import checkpoint as ckpt
  depth = data.draw(st.integers(1, 3))

  def build(d):
    if d == 0:
      shape = data.draw(st.tuples(st.integers(1, 4), st.integers(1, 4)))
      return torch.tensor(data.draw(st.lists(
          st.floats(-10, 10, allow_nan=False, width=32),
          min_size=shape[0] * shape[1], max_size=shape[0] * shape[1])),
          dtype=torch.float32).reshape(shape)
    return {f"k{i}": build(d - 1) for i in range(data.draw(st.integers(1, 3)))}

  def leaves(tree):
    if isinstance(tree, dict):
      return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [np.asarray(tree)]

  tree = {"root": build(depth)}
  with tempfile.TemporaryDirectory() as d:
    ckpt.save(d, 7, tree)
    out, step = ckpt.restore(d)
  assert step == 7
  la, lb = leaves(tree), leaves(out)
  assert len(la) == len(lb)
  for x, y in zip(la, lb):
    np.testing.assert_array_equal(x, y)


@settings(max_examples=15, deadline=None)
@given(st.data())
def test_kernel_random_shapes(data):
  """Property sweep of K1's wrapper on CPU tensors (its plain version):
  random op × shape × dtype against the unblocked oracle."""
  op = data.draw(st.sampled_from(list(ALL_OPS)))
  m = data.draw(st.integers(1, 40))
  k = data.draw(st.integers(1, 40))
  n = data.draw(st.integers(1, 40))
  f32 = data.draw(st.booleans())
  rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
  a = _t(rng.standard_normal((m, k)).astype(np.float32))
  b = _t(rng.standard_normal((k, n)).astype(np.float32))
  if op == "orand":
    a, b = a > 0.7, b > 0.7
  elif not f32:
    a, b = a.bfloat16(), b.bfloat16()
  got = semiring_mmo(a, b, op=op)
  ref = semiring_mmo_ref(a, b, op=op)
  tol = 1e-4 if (f32 or op == "orand") else 5e-2
  np.testing.assert_allclose(got.double().numpy(), ref.double().numpy(),
                             rtol=tol, atol=tol)
