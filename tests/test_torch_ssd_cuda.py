"""K4's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_ssd_cuda.py

The shapes are ``chip_smoke.py``'s: the reference kernel test's (per-head C
and B, G == H) in f32 and bf16, the mamba2-780m prefill's (BZ 4·8, H 48,
G 1, Q 256, N 128, P 64) in f32 and bf16, grouped cases with G < H and a
query length that is not a multiple of the kernel's 64-row tile, and a
decay whose exp overflows above the diagonal.  Beside them, the cases the
kernel's design has edges at: a group's heads split into CTA head blocks
with a smaller last block, a state N that is not a multiple of 8 and the
largest one, the smallest and largest head dims with G < H, a chunk longer
than the 256 keys whose scores one pass keeps, and a NaN or an inf in C, B
or X (rows at or after it take the plain version's inf/NaN pattern, earlier
rows stay finite: ROADMAP Queue 3's declared difference).  Tolerances: f32
1e-5 and bf16 5e-2 at the reference test's shapes
(tests/test_kernels_ssd.py; bf16 inputs widen to f32 exactly, so both
dtypes differ only in summation order); at the longer contractions of the
other shapes (N up to 128 products per score, Q up to 256 weighted rows per
output) f32 rtol 1e-5 with atol 1e-4, K1's f32 tolerance for sums whose
order differs.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

pytestmark = pytest.mark.cuda

# (BZ, H, G, Q, N, P)
REF_SHAPES = [(2, 4, 4, 32, 16, 8), (1, 2, 2, 64, 32, 16),
              (3, 1, 1, 16, 8, 8)]
MAIN_SHAPE = (32, 48, 1, 256, 128, 64)
GROUPED_SHAPES = [(2, 8, 2, 100, 32, 32), (2, 4, 1, 8, 16, 16),
                  (1, 6, 3, 130, 64, 128)]
# (BZ, H, G, Q, N, P) at the design's edges: N 20 and 256, P 8 and 128
# with G < H, Q 600 (three passes of 256 keys)
EDGE_SHAPES = [(2, 8, 2, 100, 20, 32), (2, 8, 1, 256, 256, 64),
               (2, 8, 2, 130, 64, 8), (2, 8, 1, 256, 128, 128),
               (1, 4, 2, 600, 32, 32)]
REF_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
LONG_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def ssd_inputs(shape, dtype, device, seed=0, decay=(0.001, 0.1)):
  """c, b (BZ, G, Q, N), x (BZ, H, Q, P), dt, cum (BZ, H, Q); cum is a
  cumsum of negative decays drawn from ``decay``."""
  bz, h, g, q, n, p = shape
  gen = torch.Generator().manual_seed(seed)
  c = torch.randn(bz, g, q, n, generator=gen)
  b = torch.randn(bz, g, q, n, generator=gen)
  x = torch.randn(bz, h, q, p, generator=gen)
  dt = torch.rand(bz, h, q, generator=gen) * 0.19 + 0.01
  lo, hi = decay
  cum = torch.cumsum(-(torch.rand(bz, h, q, generator=gen) * (hi - lo) + lo),
                     dim=-1)
  return [t.to(device, dtype) for t in (c, b, x, dt, cum)]


def _run(shape, dtype, device, **kw):
  args = ssd_inputs(shape, dtype, device, **kw)
  before = ssd.ssd_intra_chunk.launches
  got = ssd.ssd_intra_chunk(*args)
  torch.cuda.synchronize()
  assert ssd.ssd_intra_chunk.launches == before + 1
  want = ssd.ssd_intra_chunk_plain(*args)
  assert got.dtype == want.dtype == torch.float32
  assert got.shape == want.shape
  return got, want


@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_matches_plain_at_the_reference_shapes(cuda, shape, dtype):
  got, want = _run(shape, dtype, cuda)
  tol = REF_TOL[dtype]
  torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [MAIN_SHAPE] + GROUPED_SHAPES, ids=str)
def test_kernel_matches_plain_f32(cuda, shape):
  got, want = _run(shape, torch.float32, cuda, seed=1)
  torch.testing.assert_close(got, want, **LONG_TOL)


def test_exp_overflow_above_the_diagonal_stays_out(cuda):
  """Decays of 0.5–1.5 per row: exp(cum_q − cum_k) is +inf for keys far
  above the diagonal; a select keeps them out, so no inf · 0 = NaN."""
  shape = (2, 4, 1, 256, 32, 64)
  c, b, x, dt, cum = ssd_inputs(shape, torch.float32, cuda, seed=2,
                                decay=(0.5, 1.5))
  seg = cum[..., :, None] - cum[..., None, :]
  assert torch.isinf(torch.exp(seg)).any()
  got = ssd.ssd_intra_chunk(c, b, x, dt, cum)
  want = ssd.ssd_intra_chunk_plain(c, b, x, dt, cum)
  assert torch.isfinite(got).all()
  torch.testing.assert_close(got, want, **LONG_TOL)


def test_model_layout_views_and_out(cuda):
  """(z, q, head, ·) buffers read through (z, head, q, ·) views, the result
  written into a view of a (z, q, head, p) buffer, as ssd_chunked calls it."""
  args = ssd_inputs((4, 6, 2, 96, 32, 16), torch.float32, cuda, seed=3)
  views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in args]
  buf = torch.full((4, 96, 6, 16), float("nan"), device=cuda)
  got = ops.ssd_intra_chunk(*views, out=buf.transpose(1, 2))
  assert got.data_ptr() == buf.data_ptr()
  want = ssd.ssd_intra_chunk_plain(*args)
  torch.testing.assert_close(got, want, **LONG_TOL)


def test_a_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
  def refuse(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")
  args = ssd_inputs((2, 4, 1, 64, 16, 16), torch.float32, cuda, seed=4)
  want = ssd.ssd_intra_chunk_plain(*args)
  monkeypatch.setattr(ssd, "ssd_intra_chunk_plain", refuse)
  before = ssd.ssd_intra_chunk.launches
  got = ops.ssd_intra_chunk(*args)
  assert ssd.ssd_intra_chunk.launches == before + 1
  torch.testing.assert_close(got, want, **LONG_TOL)


def test_launches_count_one_per_kernel_call(cuda):
  args = ssd_inputs((1, 2, 1, 16, 8, 8), torch.float32, cuda)
  before = ssd.ssd_intra_chunk.launches
  for _ in range(3):
    ssd.ssd_intra_chunk(*args)
  assert ssd.ssd_intra_chunk.launches == before + 3
  ssd.ssd_intra_chunk_plain(*args)
  assert ssd.ssd_intra_chunk.launches == before + 3


def test_ssd_chunked_pallas_matches_xla_with_one_launch(cuda):
  """The model's scan on both arms: 4 chunks of 256, G 1, a ragged tail."""
  gen = torch.Generator().manual_seed(5)
  bsz, s, h, p, g, n = 2, 1000, 8, 64, 1, 128
  xh = torch.randn(bsz, s, h, p, generator=gen).to(cuda)
  dt = (torch.rand(bsz, s, h, generator=gen) * 0.02 + 0.005).to(cuda)
  a = -(torch.rand(h, generator=gen) + 0.5).to(cuda)
  b = torch.randn(bsz, s, g, n, generator=gen).to(cuda)
  c = torch.randn(bsz, s, g, n, generator=gen).to(cuda)
  before = ssd.ssd_intra_chunk.launches
  got, got_final = ssm.ssd_chunked(xh, dt, a, b, c, 256, impl="pallas")
  assert ssd.ssd_intra_chunk.launches == before + 1
  want, want_final = ssm.ssd_chunked(xh, dt, a, b, c, 256, impl="xla")
  torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
  torch.testing.assert_close(got_final, want_final, rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
  c, b, x, dt, cum = ssd_inputs((1, 2, 1, 16, 8, 48), torch.float32, cuda)
  with pytest.raises(ValueError, match="head dims"):
    ssd.ssd_intra_chunk(c, b, x, dt, cum)
  c, b, x, dt, cum = ssd_inputs((1, 2, 1, 16, 300, 16), torch.float32, cuda)
  with pytest.raises(ValueError, match="state"):
    ssd.ssd_intra_chunk(c, b, x, dt, cum)
  c, b, x, dt, cum = ssd_inputs((1, 2, 1, 16, 8, 16), torch.float32, cuda)
  xt = x.transpose(2, 3).contiguous().transpose(2, 3)
  with pytest.raises(ValueError, match="unit stride"):
    ssd.ssd_intra_chunk(c, b, xt, dt, cum)


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_kernel_matches_plain_at_the_design_edges(cuda, shape):
  got, want = _run(shape, torch.float32, cuda, seed=6)
  torch.testing.assert_close(got, want, **LONG_TOL)


def test_kernel_matches_plain_bf16_at_the_main_shape(cuda):
  """bf16 inputs widen exactly into f32, so the kernel is held to the f32
  tolerance of the same sums."""
  got, want = _run(MAIN_SHAPE, torch.bfloat16, cuda, seed=1)
  torch.testing.assert_close(got, want, **LONG_TOL)


@pytest.mark.parametrize("h", [40, 48])
def test_head_blocks_with_a_smaller_last_block(cuda, h):
  """A group's heads split over CTAs in blocks of more than one head, the
  last block smaller: the first batch size at which the kernel picks such a
  block on this card."""
  q, n, p = 100, 64, 64
  for bz in range(1, 257):
    hb = ssd.head_block(torch.float32, p, bz, h, 1, q)
    if 1 < hb < h and h % hb:
      break
  else:
    pytest.fail(f"no batch size up to 256 gives H={h} a ragged head block")
  got, want = _run((bz, h, 1, q, n, p), torch.float32, cuda, seed=7)
  torch.testing.assert_close(got, want, **LONG_TOL)


@pytest.mark.parametrize("value", [float("nan"), float("inf")], ids=str)
@pytest.mark.parametrize("operand", ["c", "b", "x"])
def test_non_finite_input_pattern(cuda, operand, value):
  """A NaN or an inf at position k = 100 of C, B (group 0) or X (head 1),
  in chunk 0.  Rows at or after k take the plain version's inf/NaN pattern
  and agree with it where it is finite; rows before k stay finite (the
  plain version's 0 mask carries B's and X's value to them); chunk 1 is
  untouched."""
  k = 100
  args = ssd_inputs((2, 4, 1, 256, 32, 64), torch.float32, cuda, seed=8)
  c, b, x = args[:3]
  if operand == "x":
    x[0, 1, k, 3] = value
  else:
    {"c": c, "b": b}[operand][0, 0, k, 5] = value
  got = ssd.ssd_intra_chunk(*args)
  want = ssd.ssd_intra_chunk_plain(*args)
  torch.cuda.synchronize()
  late, early = got[0, :, k:], got[0, :, :k]
  for pattern in (torch.isnan, torch.isposinf, torch.isneginf):
    assert torch.equal(pattern(late), pattern(want[0, :, k:])), (
        pattern.__name__)
  assert not torch.isfinite(late).all()
  assert torch.isfinite(early).all()
  finite = torch.isfinite(want)
  torch.testing.assert_close(got[finite], want[finite], **LONG_TOL)
  torch.testing.assert_close(got[1], want[1], **LONG_TOL)
