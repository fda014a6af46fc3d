"""A plain model of K4's tensor-core arithmetic (3×TF32), on the CPU.

K4 (``csrc/ssd.cu``) forms each chunk's scores S = C Bᵀ once per group and
the output Y = W X per head, W = (S · exp(cum_q − cum_k)) · dt_k selected
to 0 above the diagonal, both as TF32 mma products at f32 accuracy: every
f32 operand value x is split into big = x truncated to TF32 and small =
tf32_rna(x − big) (``tf32_rna`` of ``tests/test_torch_tf32_split.py``:
four instructions on the card, where K1's rounded big part takes eight),
each 8-deep group takes small·big, big·small and big·big; the score sums each 16-deep slice
of N apart and adds the slices in f32, Y each 32-key stage.  A score or an
output element that comes out of the tensor cores not finite is recomputed
as a plain f32 sum of its terms at or below the diagonal; a query row whose
C holds a value that is not finite is NaN wherever a later key exists in
the chunk, as in the plain version.  (The model sums a slice in f32
rounding to nearest; the tensor cores' own sum within a slice need not,
which the slice's few terms keep small.)

This file models that arithmetic at the main path's depths (N 128, 256
keys, P 64) and holds it where the card holds the kernel: against a
float64 result within the f32 tolerance of ``chip_smoke.py`` and the card
tests (rtol 1e-5, atol 1e-4), and against the plain version's inf/NaN
pattern at and after a non-finite input.  The card tests
(``tests/test_torch_ssd_cuda.py``) check the kernel itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import ssd_intra_chunk_plain  # noqa: E402
from test_torch_tf32_split import tf32_rna  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-4}  # K4's f32 tolerance on the card
GROUP = 8    # k depth of one mma.m16n8k8 TF32 product
N_SLICE = 16  # state columns per score stage: its products sum apart
K_SLICE = 32  # keys per X stage: its products sum apart
Q, N, P = 256, 128, 64  # the mamba2-780m prefill's chunk, state, head dim


def split(x: torch.Tensor):
  """K4's split: big = x with its 13 low bits cleared, small = the rest
  rounded to TF32 (|x − big − small| ≤ 2⁻²¹|x|)."""
  bits = x.contiguous().view(torch.int32)
  big = (bits & -0x2000).view(torch.float32)
  return big, tf32_rna(x - big)


def test_the_split_is_within_two_to_the_minus_21():
  x = torch.randn(100000, generator=torch.Generator().manual_seed(6))
  big, small = split(x)
  for t in (big, small):
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
  resid = (x.double() - big.double() - small.double()).abs()
  assert bool((resid <= 2.0 ** -21 * x.double().abs()).all())


def _sliced(a, b, depth, slice_, f32_split):
  """a (M, K) · b (K, N) as the kernel's tile sums it: per 8-deep group the
  three split products (one where ``f32_split`` is false), each slice of
  ``slice_`` summed apart and added to the total in f32."""
  if f32_split:
    (ab, as_), (bb, bs) = split(a), split(b)
    terms = ((as_, bb), (ab, bs), (ab, bb))
  else:
    terms = ((a, b),)
  acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
  for k0 in range(0, depth, slice_):
    part = torch.zeros_like(acc)
    for g in range(k0, min(k0 + slice_, depth), GROUP):
      s = slice(g, g + GROUP)
      for pa, pb in terms:
        part = part + pa[:, s] @ pb[s, :]
    acc = acc + part
  return acc


def ssd_3xtf32(c, b, x, dt, cum, *, f32_pattern=True, f32_split=True):
  """One head of one chunk as K4 computes it: c, b (Q, N), x (Q, P), dt,
  cum (Q,) in f32; returns Y (Q, P) f32.  ``f32_split=False`` takes one
  TF32 product per group (what the split avoids)."""
  q, n = c.shape
  causal = torch.ones(q, q, dtype=torch.bool).tril()
  rnd = (lambda t: t) if f32_split else tf32_rna
  s = _sliced(rnd(c), rnd(b).T.contiguous(), n, N_SLICE, f32_split)
  if f32_pattern:
    bad = ~torch.isfinite(s) & causal
    s = torch.where(bad, (c[:, None, :] * b[None, :, :]).sum(-1), s)
  decay = torch.exp(cum[:, None] - cum[None, :])
  w = torch.where(causal, (s * decay) * dt[None, :], 0.0)
  y = _sliced(rnd(w), rnd(x), q, K_SLICE, f32_split)
  if f32_pattern:
    plain = torch.where(causal[:, :, None], w[:, :, None] * x[None, :, :],
                        0.0).sum(1)
    c_bad = ~torch.isfinite(c).all(1)
    later = torch.arange(q) < q - 1
    fixed = torch.where((c_bad & later)[:, None], float("nan"), plain)
    y = torch.where(torch.isfinite(y), y, fixed)
  return y


def _inputs(seed, decay=(0.001, 0.1), g=1, h=2):
  """chip_smoke.py's K4 operands at the main depths: c, b (1, G, Q, N),
  x (1, H, Q, P), dt, cum (1, H, Q)."""
  rng = np.random.default_rng(seed)
  c = rng.standard_normal((1, g, Q, N)).astype(np.float32)
  b = rng.standard_normal((1, g, Q, N)).astype(np.float32)
  x = rng.standard_normal((1, h, Q, P)).astype(np.float32)
  dt = rng.uniform(0.01, 0.2, (1, h, Q)).astype(np.float32)
  cum = np.cumsum(-rng.uniform(*decay, (1, h, Q)), axis=-1).astype(np.float32)
  return [torch.from_numpy(t) for t in (c, b, x, dt, cum)]


def _model(c, b, x, dt, cum, **kw):
  """The model over (1, G, ...) / (1, H, ...) operands, head by head."""
  h, g = x.shape[1], c.shape[1]
  return torch.stack([ssd_3xtf32(c[0, i // (h // g)], b[0, i // (h // g)],
                                 x[0, i], dt[0, i], cum[0, i], **kw)
                      for i in range(h)])[None]


def _exact(c, b, x, dt, cum):
  """The function in float64 on the f32 inputs."""
  h, g = x.shape[1], c.shape[1]
  c, b, x, dt, cum = (t.double() for t in (c, b, x, dt, cum))
  causal = torch.ones(Q, Q, dtype=torch.bool).tril()
  out = []
  for i in range(h):
    s = c[0, i // (h // g)] @ b[0, i // (h // g)].T
    decay = torch.exp(cum[0, i][:, None] - cum[0, i][None, :])
    w = torch.where(causal, s * decay * dt[0, i][None, :], 0.0)
    out.append(w @ x[0, i])
  return torch.stack(out)[None]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("decay", [(0.001, 0.1), (0.5, 1.5)], ids=str)
def test_three_products_hold_the_f32_tolerance(seed, decay):
  """The model against float64 at N 128 and 256 keys, the decay of the
  card tests' main shape and one whose exp overflows above the diagonal;
  the plain f32 version is held there too (so the kernel is held to a
  reference within the tolerance of the exact result)."""
  args = _inputs(seed, decay)
  want = _exact(*args).numpy()
  np.testing.assert_allclose(_model(*args).double().numpy(), want, **TOL)
  np.testing.assert_allclose(ssd_intra_chunk_plain(*args).double().numpy(),
                             want, **TOL)


def test_one_tf32_product_does_not_hold_it():
  """Why the split: one TF32 product per group misses the tolerance."""
  args = _inputs(2)
  one = _model(*args, f32_split=False).double().numpy()
  assert not np.allclose(one, _exact(*args).numpy(), **TOL)


def test_bf16_inputs_hold_the_f32_tolerance():
  """bf16 values are TF32 values: C Bᵀ is exact in one product per group,
  X's small part is 0; W is formed in f32 and split."""
  args = [t.to(torch.bfloat16).float() for t in _inputs(3)]
  for t in args[:3]:
    big, small = split(t)
    assert torch.equal(big, t) and bool((small == 0).all())
  np.testing.assert_allclose(_model(*args).double().numpy(),
                             _exact(*args).numpy(), **TOL)


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")], ids=str)
@pytest.mark.parametrize("operand", ["c", "b", "x"])
def test_non_finite_input_takes_the_plain_pattern(operand, value):
  """A non-finite value at position k = 100: rows at or after k take the
  plain version's inf/NaN pattern, rows before k stay finite, and finite
  values agree with the plain version."""
  k = 100
  args = _inputs(4)
  c, b, x = args[:3]
  if operand == "x":
    x[0, 1, k, 3] = value
  else:
    {"c": c, "b": b}[operand][0, 0, k, 5] = value
  got = _model(*args)
  want = ssd_intra_chunk_plain(*args)
  for pattern in (torch.isnan, torch.isposinf, torch.isneginf):
    assert torch.equal(pattern(got[:, :, k:]), pattern(want[:, :, k:])), (
        pattern.__name__)
  assert not torch.isfinite(got[:, :, k:]).all()
  assert torch.isfinite(got[:, :, :k]).all()
  finite = torch.isfinite(want)
  torch.testing.assert_close(got[finite], want[finite], **TOL)


def test_the_split_alone_turns_inf_into_nan():
  """Why the epilogue recomputes: an inf in B at key k makes the score ±inf
  in f32, but the split's cross terms meet a small part of 0 (C values
  exact in TF32) and give NaN."""
  k = 100
  c, b, x, dt, cum = _inputs(5)
  c = torch.round(c * 4) / 4  # exact in TF32: small parts 0
  b[0, 0, k, 5] = float("inf")
  naive = _model(c, b, x, dt, cum, f32_pattern=False)
  want = ssd_intra_chunk_plain(c, b, x, dt, cum)
  assert bool(torch.isinf(want[:, :, k:]).any())
  assert bool(torch.isnan(naive[:, :, k:]).all())
