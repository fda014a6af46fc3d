"""K3's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

The shapes are ``chip_smoke.py``'s: the LM main path (tinyllama prefill,
bf16, B 4, H 32, Hkv 4, S 2048, D 64, causal), the reference's FA_CASES in
f32 and in bf16 (all five head dims, Sq ≠ Skv, a window, non-causal), the
rows that see no key in both dtypes, a steep score whose running max jumps
between kv tiles, and strided views with ``out=``; head dim 112 (zamba2's
shared attention block) in both dtypes, its prefill shape, Sq ≠ Skv and a
strided view with ``out=``.  Tolerances: f32 atol
2e-5 (the reference kernel test's own; the summation order differs), bf16
atol 3e-2 (the reference's own; the bf16 instance also rounds P to bf16
for the second product, as flash-attention kernels on this card do).
"""
import importlib
import pytest

torch = pytest.importorskip("torch")

fa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

FA_CASES = [
    # b, h, hkv, sq, skv, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 160, 32, True, None),
    (2, 4, 4, 128, 128, 64, False, None),
    (1, 4, 1, 200, 200, 64, True, 96),
    (1, 2, 2, 64, 256, 128, True, None),
    (1, 4, 4, 160, 160, 80, True, None),
]
BF16_CASES = [
    (4, 32, 4, 2048, 2048, 64, True, None),   # tinyllama prefill, B 4
    (1, 16, 2, 300, 300, 128, True, None),    # head dim 128 (qwen, granite)
    (1, 8, 2, 200, 200, 80, True, 64),        # head dim 80 with a window
    (2, 4, 2, 40, 40, 16, True, None),        # the smoke configs' head dim
]
# head dim 112 (zamba2-7b's shared block: 32 heads, 32 kv heads)
D112_CASES = [
    (4, 32, 32, 2048, 2048, 112, True, None),  # zamba2 prefill, B 4
    (1, 8, 8, 96, 160, 112, True, None),       # Sq ≠ Skv
    (1, 4, 2, 200, 200, 112, True, 64),        # GQA, a window
]


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def _qkv(case, dtype, device, seed):
  b, h, hkv, sq, skv, d = case[:6]
  g = torch.Generator().manual_seed(seed)
  q = torch.randn(b, h, sq, d, generator=g)
  k = torch.randn(b, hkv, skv, d, generator=g)
  v = torch.randn(b, hkv, skv, d, generator=g)
  return (x.to(device, dtype) for x in (q, k, v))


def _run(case, dtype, device, seed=0):
  causal, window = case[6], case[7]
  q, k, v = _qkv(case, dtype, device, seed)
  before = fa.flash_attention.launches
  got = ops.flash_attention(q, k, v, causal=causal, window=window)
  torch.cuda.synchronize()
  assert fa.flash_attention.launches == before + 1
  want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
  assert got.dtype == dtype and got.shape == want.shape
  return got.float(), want.float()


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_kernel_matches_plain_f32(cuda, case):
  got, want = _run(case, torch.float32, cuda)
  torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_kernel_matches_plain_bf16(cuda, case):
  got, want = _run(case, torch.bfloat16, cuda)
  torch.testing.assert_close(got, want, rtol=0, atol=3e-2)


@pytest.mark.parametrize("case", [
    (1, 2, 2, 96, 64, 32, True, None),   # rows 0..31 see no key
    (1, 2, 1, 70, 20, 16, True, 8),      # kv shorter than a tile
    (1, 2, 1, 1, 130, 64, True, 40),     # one query row, a window
    (1, 2, 1, 130, 130, 64, True, 0),    # a window that empties every row
], ids=str)
def test_kernel_matches_plain_on_ragged_and_keyless_rows(cuda, case):
  got, want = _run(case, torch.float32, cuda, seed=3)
  assert not torch.isnan(got).any()
  torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_kernel_matches_plain_bf16_on_the_reference_cases(cuda, case):
  got, want = _run(case, torch.bfloat16, cuda)
  torch.testing.assert_close(got, want, rtol=0, atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rows_with_no_key_are_the_mean_of_v(cuda, dtype):
  """Sq > Skv, causal: rows 0..31 sit before every key and end as the mean
  of V (the TPU kernel's finite sentinel): every P there is exactly 1, in
  bf16 too.  atol: f32 1e-5; bf16 one ulp of the output (2⁻⁸ below 1)."""
  case = (1, 2, 2, 96, 64, 32, True, None)
  q, k, v = _qkv(case, dtype, cuda, 5)
  got = ops.flash_attention(q, k, v, causal=True)[:, :, :32].float()
  mean_v = v.float().mean(dim=2, keepdim=True).expand_as(got)
  atol = 1e-5 if dtype == torch.float32 else 2 ** -8
  torch.testing.assert_close(got, mean_v, rtol=0, atol=atol)


def test_steep_scores_rescale_with_bf16_p(cuda):
  """q scaled by 20: the running max jumps between kv tiles by tens, so the
  rescale of O and l carries the result, with P rounded to bf16."""
  case = (2, 8, 2, 512, 512, 64, True, None)
  q, k, v = _qkv(case, torch.float32, cuda, 9)
  q, k, v = (q * 20).bfloat16(), k.bfloat16(), v.bfloat16()
  got = ops.flash_attention(q, k, v, causal=True)
  want = fa.flash_attention_plain(q, k, v, causal=True)
  assert not torch.isnan(got).any()
  torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", D112_CASES, ids=str)
def test_head_dim_112_matches_plain(cuda, case, dtype):
  got, want = _run(case, dtype, cuda, seed=6)
  atol = 2e-5 if dtype == torch.float32 else 3e-2
  torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_head_dim_112_strided_views_with_out(cuda, dtype):
  """zamba2's layout: (B, S, H, 112) projections read through transposed
  views and written into a view of a (B, S, H, 112) buffer."""
  b, h, s, d = 2, 8, 300, 112
  g = torch.Generator().manual_seed(7)
  qb, kb, vb = (torch.randn(b, s, h, d, generator=g).to(cuda, dtype)
                for _ in range(3))
  q, k, v = (t.transpose(1, 2) for t in (qb, kb, vb))
  want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
  buf = torch.full_like(qb, float("nan"))
  ops.flash_attention(q, k, v, out=buf.transpose(1, 2))
  torch.cuda.synchronize()
  assert torch.equal(buf.transpose(1, 2), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_strided_views_with_out(cuda, dtype):
  """q, k, v as transposed views of (B, S, H, D) buffers and ``out=`` a view
  of one, as models/attention.py launches K3: one launch, the contiguous
  call's bits, in the caller's buffer."""
  b, h, hkv, s, d = 2, 8, 2, 300, 64
  g = torch.Generator().manual_seed(4)
  qb, kb, vb = (torch.randn(b, s, n, d, generator=g).to(cuda, dtype)
                for n in (h, hkv, hkv))
  q, k, v = (t.transpose(1, 2) for t in (qb, kb, vb))
  want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=100)
  buf = torch.full_like(qb, float("nan"))
  before = fa.flash_attention.launches
  got = ops.flash_attention(q, k, v, causal=True, window=100,
                            out=buf.transpose(1, 2))
  torch.cuda.synchronize()
  assert fa.flash_attention.launches == before + 1
  assert got.data_ptr() == buf.data_ptr()
  assert torch.equal(buf.transpose(1, 2), want)


def test_kernel_refuses_what_it_does_not_take(cuda):
  q = torch.zeros(1, 2, 8, 48, device=cuda)
  with pytest.raises(ValueError, match="head dims"):
    fa.flash_attention(q, q, q)
  q = torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3)
  with pytest.raises(ValueError, match="unit stride"):
    fa.flash_attention(q, q, q)
