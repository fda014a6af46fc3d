"""A plain model of mma on the tensor cores (3×TF32), on the CPU.

K1 and K2 run the mma ring as TF32 wgmma products (``semiring_ring.cuh``,
``contract_tc``): each f32 operand value x is split into
big = tf32_rna(x) and small = tf32_rna(x − big) (small = 0 where big is not
finite), each 8-deep k group takes A_small·B_big, A_big·B_small and
A_big·B_big, each 32-deep slab's twelve products are summed apart and the
slab sums added in f32 with Kahan's compensation; where a term of an
element is not finite, the element takes the f32 product's inf/NaN
pattern.  (The model sums a slab in f32 rounding to nearest; the tensor
cores' own sum within a slab need not, which the slab's few terms keep
small.)  This file models that
arithmetic with integer bit operations and f32 matmuls, and holds it where
the card is held: against a float64 product within the f32 tolerance the
card tests and ``chip_smoke.py`` use, and against the plain f32 product's
inf/NaN pattern.  It predicts on the CPU what the card shows; the card
tests (``tests/test_torch_kernels_cuda.py``) check the kernel itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.semiring_mmo import semiring_mmo_plain  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-4}  # f32 mma: the card tests' tolerance
GROUP = 8  # k depth of one wgmma.m64n128k8 TF32 product
SLAB = 32  # k depth of one staged slab: its products are summed apart


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
  """Round f32 to TF32 (10 stored significand bits), to nearest with ties
  away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits'
  range to the magnitude, then clear them.  NaN stays NaN."""
  bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  sign = bits & 0x80000000
  mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
  out = (sign | mag)
  out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
  return torch.where(torch.isnan(x), x, out.view(torch.float32))


def split(x: torch.Tensor):
  big = tf32_rna(x)
  small = torch.where(torch.isfinite(big), tf32_rna(x - big),
                      torch.zeros_like(x))
  return big, small


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor, *, f32_pattern=True):
  """(M, K) · (K, N) as the tensor-core tile computes it, in f32."""
  (ab, as_), (bb, bs) = split(a), split(b)
  acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
  carry = torch.zeros_like(acc)
  for k0 in range(0, a.shape[1], SLAB):
    part = torch.zeros_like(acc)
    for g in range(k0, min(k0 + SLAB, a.shape[1]), GROUP):
      s = slice(g, g + GROUP)
      for pa, pb in ((as_, bb), (ab, bs), (ab, bb)):
        part = part + pa[:, s] @ pb[s, :]
    y = part - carry
    t = acc + y
    carry = (t - acc) - y
    acc = t
  if f32_pattern and not (torch.isfinite(a).all() and torch.isfinite(b).all()):
    terms = a[:, :, None] * b[None, :, :]
    nan = torch.isnan(terms).any(1)
    pos, neg = torch.isposinf(terms).any(1), torch.isneginf(terms).any(1)
    acc = torch.where(nan | (pos & neg), float("nan"),
                      torch.where(pos, float("inf"),
                                  torch.where(neg, float("-inf"), acc)))
  return acc


def test_tf32_rounding_is_nearest_ties_away():
  one = 1.0
  x = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -11,
                    -(one + 2 ** -11), 2 ** -130 * 1.5, float("inf"),
                    float("-inf"), 0.0, -0.0], dtype=torch.float32)
  want = torch.tensor([one + 2 ** -10, one, one + 2 ** -9,
                       -(one + 2 ** -10), 2 ** -130 * 1.5, float("inf"),
                       float("-inf"), 0.0, -0.0], dtype=torch.float32)
  assert torch.equal(tf32_rna(x).view(torch.int32), want.view(torch.int32))
  assert bool(torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all())
  # the 13 low bits clear, within half a TF32 ulp (2⁻¹¹ relative)
  x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
  r = tf32_rna(x)
  assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
  assert bool(((r - x).abs() <= 2.0 ** -11 * x.abs()).all())


def test_the_split_is_exact_to_f32():
  """x − big is exact in f32, and big + small leaves at most 2⁻²² |x|."""
  x = torch.randn(100000, generator=torch.Generator().manual_seed(1))
  big, small = split(x)
  assert torch.equal((big.double() + (x - big).double()), x.double())
  resid = (x.double() - big.double() - small.double()).abs()
  assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())


def test_bf16_values_are_exact_in_tf32():
  """bf16 inputs take one TF32 product per k group: widened, they are TF32
  values already, and their small part is 0."""
  x = torch.randn(10000, generator=torch.Generator().manual_seed(2)).to(
      torch.bfloat16).float()
  big, small = split(x)
  assert torch.equal(big, x) and bool((small == 0).all())


@pytest.mark.parametrize("k", [16, 384, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_products_hold_the_f32_tolerance(k, seed):
  """chip_smoke.py's mma inputs (standard normal f32) at K up to 4096, the
  model against a float64 product; one TF32 product alone does not hold the
  tolerance at K = 4096."""
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((64, k)).astype(np.float32)
  b = rng.standard_normal((k, 48)).astype(np.float32)
  want = a.astype(np.float64) @ b.astype(np.float64)
  got = mma_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
  np.testing.assert_allclose(got, want, **TOL)
  if k == 4096:
    one = (tf32_rna(torch.from_numpy(a)) @ tf32_rna(torch.from_numpy(b)))
    assert not np.allclose(one.double().numpy(), want, **TOL)


def _non_finite_operands():
  g = torch.Generator().manual_seed(3)
  a = torch.randn(40, 24, generator=g)
  b = torch.randn(24, 30, generator=g)
  b[5, :] = torch.round(b[5, :] * 4)  # exact in TF32: small part 0
  a[3, 5] = float("inf")               # row 3: ±inf (0 · inf NaN if b = 0)
  a[10, 2], a[10, 9] = float("-inf"), float("inf")  # +inf and −inf: NaN
  b[4, 7] = float("nan")               # column 7: NaN
  b[6, 20] = float("inf")
  a[12, 6] = 0.0                       # 0 · inf: NaN at (12, 20)
  return a, b


def test_non_finite_inputs_give_the_f32_pattern():
  a, b = _non_finite_operands()
  got = mma_3xtf32(a, b)
  want = semiring_mmo_plain(a[None], b[None], op="mma")[0]
  for pattern in (torch.isnan, torch.isposinf, torch.isneginf):
    assert torch.equal(pattern(got), pattern(want)), pattern.__name__
  finite = torch.isfinite(want)
  torch.testing.assert_close(got[finite], want[finite], **TOL)


def test_the_split_alone_turns_inf_into_nan():
  """Why the tile takes the f32 pattern: without it, inf · x for x exact in
  TF32 meets x's small part 0 in a cross term and gives NaN."""
  a, b = _non_finite_operands()
  naive = mma_3xtf32(a, b, f32_pattern=False)
  want = semiring_mmo_plain(a[None], b[None], op="mma")[0]
  assert bool(torch.isinf(want[3, :]).any())
  assert bool(torch.isnan(naive[3, :]).all())
