"""float16 and int32 operands on every arm, against the reference.

The reference keeps an operand's dtype where its ring does: the ``xla`` and
``vector`` arms compute in ``acc_dtype`` (int32 stays int32, even under mma
and addnorm), the Pallas arm returns f32 for mma and addnorm and the input
dtype for the min/max rings, and the fused closure iterates in ``c.dtype``.
Each test below runs the same numpy inputs through both packages: the
min/max rings and orand bit-exact, mma and addnorm within rtol 1e-5 /
atol 1e-4 (sums in another order), dtypes always equal.

int32 ⊗ wraps in two's complement on every arm, as jnp's int32 and torch's
do.  Where the reference's Pallas arm pads a K tail with ±inf cast to
int32 (INT32_MAX + INT32_MAX wraps to −2), minplus, maxplus and minmul
are wrong there; the port's kernel masks the tail exactly, so those cases
are held against the reference's vector arm instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import semiring as jsr  # noqa: E402
from repro.core.mmo import mmo as jmmo  # noqa: E402
from repro.kernels import closure_megakernel as jmk  # noqa: E402
from repro.serve_mmo import MMOEngine as JEngine  # noqa: E402
from repro.serve_mmo import mmo_request as j_mmo_request  # noqa: E402
from repro_torch.core import closure as tcl  # noqa: E402
from repro_torch.core.mmo import mmo as tmmo  # noqa: E402
from repro_torch.kernels import closure_megakernel as tmk  # noqa: E402
from repro_torch.kernels.semiring_mmo import semiring_mmo_plain  # noqa: E402
from repro_torch.serve_mmo import MMOEngine, RequestArena  # noqa: E402
from repro_torch.serve_mmo import closure_request, mmo_request  # noqa: E402
from repro_torch.serve_mmo.scheduler import request_bucket  # noqa: E402

ALL_OPS = jsr.ALL_OPS
MIN_MAX = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin")
IDENTITY_RINGS = MIN_MAX + ("mma",)  # orand iterates in bool
DTYPES = {"int32": (np.int32, torch.int32), "float16": (np.float16,
                                                       torch.float16)}
I32_MAX = np.iinfo(np.int32).max
TOL = dict(rtol=1e-5, atol=1e-4)


def _operand(rng, op, dtype, shape):
  if op == "orand":
    return (rng.random(shape) < 0.4).astype(dtype)
  if dtype == np.int32:
    return rng.integers(-20, 21, shape).astype(np.int32)
  return rng.standard_normal(shape).astype(np.float16)


def _same(got, want, op):
  """got: a torch tensor; want: a reference array."""
  want = np.asarray(want)
  assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
  got = got.numpy()
  if op in ("mma", "addnorm"):
    np.testing.assert_allclose(got, want, **TOL)
  else:
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("backend", ["xla", "vector"])
def test_xla_and_vector_arms_keep_the_reference_dtype(backend, dtype, op):
  """The vector arm sums int32 in int32 (torch.sum would widen to int64)."""
  rng = np.random.default_rng(ALL_OPS.index(op))
  a = _operand(rng, op, DTYPES[dtype][0], (5, 16))
  b = _operand(rng, op, DTYPES[dtype][0], (16, 7))
  want = jmmo(jnp.asarray(a), jnp.asarray(b), op=op, backend=backend)
  got = tmmo(torch.from_numpy(a), torch.from_numpy(b), op=op,
             backend=backend)
  _same(got, want, op)


@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pallas_arm_matches_the_reference_pallas_arm(dtype, op):
  """The kernel arm (its plain version on the CPU) against the reference's
  Pallas kernel in interpret mode, C folded in, K a whole number of the
  reference's 8-lane slivers."""
  rng = np.random.default_rng(10 + ALL_OPS.index(op))
  npd = DTYPES[dtype][0]
  a = _operand(rng, op, npd, (5, 16))
  b = _operand(rng, op, npd, (16, 7))
  want = jmmo(jnp.asarray(a), jnp.asarray(b), op=op, backend="pallas",
              interpret=True)
  c = _operand(rng, op, npd, (5, 7)).astype(np.asarray(want).dtype)
  want = jmmo(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), op=op,
              backend="pallas", interpret=True)
  got = tmmo(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
             op=op, backend="pallas")
  _same(got, want, op)


@pytest.mark.parametrize("op", MIN_MAX)
def test_pallas_int32_wraps_and_masks_the_k_tail_exactly(op):
  """K = 5 (a K tail in the reference's kernel) with INT32_MAX operands:
  ⊗ wraps like the reference's vector arm computes it, bit for bit."""
  rng = np.random.default_rng(3)
  a = rng.integers(-20, 21, (4, 5)).astype(np.int32)
  b = rng.integers(-20, 21, (5, 6)).astype(np.int32)
  a[0, :] = I32_MAX
  b[:, 1] = 2
  want = jmmo(jnp.asarray(a), jnp.asarray(b), op=op, backend="vector")
  got = tmmo(torch.from_numpy(a), torch.from_numpy(b), op=op,
             backend="pallas")
  _same(got, want, op)
  if op == "minplus":  # INT32_MAX ⊗ 1 wraps to INT32_MIN
    b[0, 0] = 1
    got = tmmo(torch.from_numpy(a[:1, :1]), torch.from_numpy(b[:1, :1]),
               op=op, backend="pallas")
    assert got.item() == np.iinfo(np.int32).min


@pytest.mark.parametrize("op", MIN_MAX)
def test_plain_int32_k_valid_contracts_only_live_lanes(op):
  """Lanes past k_valid take (⊕-identity, ⊗-identity) pads, which cannot
  wrap: each request equals the contraction of its live lanes alone."""
  rng = np.random.default_rng(4)
  a = torch.from_numpy(rng.integers(-9, 10, (3, 6, 20)).astype(np.int32))
  b = torch.from_numpy(rng.integers(-9, 10, (3, 20, 5)).astype(np.int32))
  a[:, 0, :] = I32_MAX
  kv = torch.tensor([20, 7, 0], dtype=torch.int32)
  got = semiring_mmo_plain(a, b, op=op, k_valid=kv)
  assert got.dtype == torch.int32
  for r, k in enumerate(kv.tolist()):
    want = semiring_mmo_plain(a[r:r + 1, :, :k].contiguous(),
                                  b[r:r + 1, :k, :].contiguous(), op=op)
    assert torch.equal(got[r], want[0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_arm_engine_serves_float16_and_int32(dtype):
  """MMOEngine(backend="pallas") serves a minplus mmo_request of each dtype
  with no retry and no failure on its breaker.  float16 equals the
  reference engine's result.  The reference engine cannot stack an int32
  minplus request (its batcher fills pads with inf); the port pads int32
  with (INT32_MAX, 0) and equals the reference's Pallas arm."""
  rng = np.random.default_rng(5)
  npd = DTYPES[dtype][0]
  a = _operand(rng, "minplus", npd, (12, 16))
  b = _operand(rng, "minplus", npd, (16, 9))
  jeng = JEngine(backend="pallas", max_batch=2)
  jfut = jeng.submit(j_mmo_request(a, b, op="minplus"))
  jeng.run_until_idle()
  if dtype == "int32":
    with pytest.raises(OverflowError):
      jfut.result()
    want = np.asarray(jmmo(jnp.asarray(a), jnp.asarray(b), op="minplus",
                           backend="pallas", interpret=True))
  else:
    want = jfut.result().value
  eng = MMOEngine(backend="pallas", max_batch=2, device="cpu")
  fut = eng.submit(mmo_request(a, b, op="minplus"))
  eng.run_until_idle()
  got = fut.result().value
  assert got.dtype == want.dtype == npd
  np.testing.assert_array_equal(got, want)
  snap = eng.metrics_snapshot()
  assert snap["counters"]["retries"] == 0
  assert snap["counters"]["failed"] == 0
  assert snap["batch_failures_by_kind"] == {}
  breakers = eng.observability_state()["breakers"]
  assert all(c["consecutive_failures"] == 0 and c["opens"] == 0
             for c in breakers)


def _closure_input(op, dtype, n, r, seed):
  """(R, n, n) prepared adjacencies of ring ``op`` in ``dtype``: the ring's
  self value on the diagonal, no missing edges (int32 has no inf)."""
  rng = np.random.default_rng(seed)
  if dtype == np.int32:
    lo, hi = {"minmul": (1, 4), "maxmul": (0, 3), "minmax": (-50, 51),
              "maxmin": (-50, 51), "mma": (0, 2)}.get(op, (1, 10))
    x = rng.integers(lo, hi, (r, n, n))
  else:
    lo, hi = (0.2, 1.0) if op in ("minmul", "maxmul", "mma") else (0.0, 5.0)
    x = rng.uniform(lo, hi, (r, n, n))
  if op == "mma":  # strictly upper-triangular: the closure stays finite
    x = np.triu(x, k=1) * (0.1 if dtype != np.int32 else 1)
  elif op in ("minplus", "maxplus", "minmul", "maxmul"):
    x[:, np.arange(n), np.arange(n)] = 0 if op.endswith("plus") else 1
  return x.astype(dtype)


SOLVERS = {"leyzorek": tcl.batched_leyzorek_closure,
           "bellman_ford": tcl.batched_bellman_ford_closure}


@pytest.mark.parametrize("op", MIN_MAX)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("algorithm", sorted(SOLVERS))
def test_fused_arm_matches_the_reference_megakernel(algorithm, dtype, op):
  """The reference's megakernel iterates in c.dtype (float16 rounded at
  each step's store; int32 wherever its layout needs no padding: n = 16).
  The port's fused arm gives its bits and iteration counts."""
  x = _closure_input(op, DTYPES[dtype][0], 16, 2, seed=MIN_MAX.index(op))
  want, want_it = jmk.megakernel_fixpoint(jnp.asarray(x), op=op,
                                          algorithm=algorithm, g=3,
                                          interpret=True)
  got, it = tmk.megakernel_fixpoint(torch.from_numpy(x), op=op,
                                    algorithm=algorithm, g=3)
  _same(got, want, op)
  assert it.tolist() == np.asarray(want_it).tolist()


@pytest.mark.parametrize("op", IDENTITY_RINGS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("algorithm", sorted(SOLVERS))
def test_fused_arm_is_the_dispatch_arm_bit_for_bit(algorithm, dtype, op):
  """The port's three closure paths share one contraction: the fused arm
  (K2's plain version) equals the per-iteration kernel arm bit for bit,
  iteration counts included, with ragged valid_n."""
  x = torch.from_numpy(_closure_input(op, DTYPES[dtype][0], 13, 3, seed=9))
  valid = torch.tensor([13, 9, 4], dtype=torch.int32)
  solve = SOLVERS[algorithm]
  want, want_it = solve(x, op=op, backend="pallas", valid_n=valid)
  got, it = solve(x, op=op, fixpoint_backend="megakernel", megakernel_g=3,
                  valid_n=valid)
  assert got.dtype == want.dtype
  assert torch.equal(it, want_it)
  assert torch.equal(got, want) or (
      got.dtype.is_floating_point and bool(torch.all(
          (got == want) | (torch.isnan(got) & torch.isnan(want)))))


@pytest.mark.parametrize("op", ("minplus", "maxmin", "maxmul", "mma"))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_arena_is_the_dispatch_arm_on_float16_and_int32(dtype, op):
  """Requests of the bucket's own size (int32 cannot be padded: its no-edge
  value would be inf) through a request arena's slots equal the batch
  path's per-iteration kernel arm, values and iteration counts."""
  x = _closure_input(op, DTYPES[dtype][0], 16, 3, seed=11)
  reqs = [closure_request(g, op=op, algorithm="leyzorek", prepared=True)
          for g in x]
  key = request_bucket(reqs[0])
  assert key.shape[0] == 16
  arena = RequestArena(key, capacity=2, g=2, device="cpu")
  pending, done = list(reqs), {}
  while pending or arena.live_slots():
    while pending and arena.free_slots():
      arena.admit(pending.pop(0))
    arena.tick()
    for ev in arena.sweep():
      done[id(ev.request)] = ev
  for g, req in zip(x, reqs):
    want, want_it = tcl.batched_leyzorek_closure(
        torch.from_numpy(g)[None], op=op, backend="pallas")
    ev = done[id(req)]
    got = np.asarray(ev.value)
    assert got.dtype == want.numpy().dtype
    np.testing.assert_array_equal(got, want[0].numpy())
    assert int(ev.iterations) == int(want_it[0])
