"""K3's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

The shapes are ``chip_smoke.py``'s: the LM main path (tinyllama prefill,
bf16, B 4, H 32, Hkv 4, S 2048, D 64, causal), the reference's FA_CASES in
f32, head dim 128 in bf16, and the rows that see no key.  Tolerances: f32
atol 2e-5 (the reference kernel test's own; the summation order differs),
bf16 atol 3e-2 (the reference's own; one bf16 rounding of the output).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
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


def test_kernel_refuses_what_it_does_not_take(cuda):
  q = torch.zeros(1, 2, 8, 48, device=cuda)
  with pytest.raises(ValueError, match="head dims"):
    fa.flash_attention(q, q, q)
  q = torch.zeros(1, 2, 8, 64, device=cuda)
  with pytest.raises(ValueError, match="contiguous"):
    fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
