"""K3 (flash attention) and its plain version against the reference.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the reference Pallas kernel run in interpret mode (as
tests/test_kernels.py runs it) with the same tiles (64 × 64, the CUDA
kernel's), and ``attention_ref`` against ``attention_ref``.

Tolerances: f32 atol 2e-5, the reference kernel test's own (summation order
differs); bf16 atol 3e-2, also the reference's own (one bf16 rounding of the
output, plus the f32 summation order).  The no-key-rows case is held in f32
at 2e-5 too: both kernels return the mean of V there.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_flash_attention_cuda.py.
"""
import importlib
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as j_fa  # noqa: E402
from repro.kernels.ref import attention_ref as j_attention_ref  # noqa: E402
fa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the reference kernel sweep (tests/test_kernels.py)
FA_CASES = [
    # b, h, hkv, sq, skv, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 160, 32, True, None),
    (2, 4, 4, 128, 128, 64, False, None),
    (1, 4, 1, 200, 200, 64, True, 96),
    (1, 2, 2, 64, 256, 128, True, None),
    (1, 4, 4, 160, 160, 80, True, None),   # non-128-aligned head dim
    (1, 4, 4, 96, 160, 112, True, None),   # zamba2's head dim, Sq ≠ Skv
    (2, 4, 4, 64, 256, 64, False, None),   # cross-attention: Sq < Skv, no mask
]
BQ, BKV = fa.TILE


def _qkv(b, h, hkv, sq, skv, d, seed):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
  k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
  v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
  return q, k, v


def _ref_kernel(q, k, v, **kw):
  return np.asarray(j_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         bq=BQ, bkv=BKV, interpret=True, **kw), np.float32)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_plain_matches_reference_kernel(case):
  b, h, hkv, sq, skv, d, causal, window = case
  q, k, v = _qkv(b, h, hkv, sq, skv, d, seed=sum(case[:6]))
  want = _ref_kernel(q, k, v, causal=causal, window=window)
  got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, window=window)
  assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
  np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_plain_matches_dense_oracle(case):
  """Both packages' dense oracle on the GQA-expanded k, v: the port's plain
  kernel equals it where every row sees a key."""
  b, h, hkv, sq, skv, d, causal, window = case
  q, k, v = _qkv(b, h, hkv, sq, skv, d, seed=7 + sum(case[:6]))
  kx, vx = np.repeat(k, h // hkv, axis=1), np.repeat(v, h // hkv, axis=1)
  want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(kx),
                                    jnp.asarray(vx), causal=causal,
                                    window=window))
  oracle = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(kx),
                              torch.from_numpy(vx), causal=causal,
                              window=window)
  np.testing.assert_allclose(oracle.numpy(), want, atol=2e-5)
  got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, window=window)
  np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_bf16_matches_reference_kernel():
  rng = np.random.default_rng(11)
  q, k, v = (rng.standard_normal((1, 4, 64, 64)).astype(np.float32)
             for _ in range(3))
  jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
  want = np.asarray(j_fa(jq, jk, jv, bq=BQ, bkv=BKV, interpret=True),
                    np.float32)
  tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
  got = fa.flash_attention(tq, tk, tv)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)
  oracle = tref.attention_ref(tq, tk, tv)
  np.testing.assert_allclose(
      oracle.float().numpy(),
      np.asarray(j_attention_ref(jq, jk, jv), np.float32), atol=3e-2)


def test_rows_with_no_key_match_the_reference_kernel():
  """Sq > Skv, causal: rows 0..31 sit before every key.  The TPU kernel's
  finite sentinel makes them the mean of V over the block that ran; the port
  returns the same, and the dense oracle returns NaN there."""
  q, k, v = _qkv(1, 2, 2, 96, 64, 32, seed=5)
  want = _ref_kernel(q, k, v, causal=True)
  got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True).numpy()
  np.testing.assert_allclose(got, want, atol=2e-5)
  np.testing.assert_allclose(got[:, :, :32],
                             np.broadcast_to(v.mean(axis=2, keepdims=True),
                                             (1, 2, 32, 32)), atol=1e-6)
  dense = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v)).numpy()
  assert np.isnan(dense[:, :, :32]).all()
  np.testing.assert_allclose(got[:, :, 32:], dense[:, :, 32:], atol=2e-5)


@pytest.mark.parametrize("sq,skv,window", [(5, 3, None), (70, 20, 8),
                                           (1, 130, 40), (130, 130, 0)])
def test_ragged_tiles_and_empty_windows(sq, skv, window):
  """Tails shorter than a tile on both axes, a window that empties rows."""
  q, k, v = _qkv(1, 2, 1, sq, skv, 16, seed=sq + skv)
  want = _ref_kernel(q, k, v, causal=True, window=window)
  got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window)
  np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
  q = torch.zeros(1, 3, 8, 16)
  with pytest.raises(ValueError, match="group"):
    fa.flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
  with pytest.raises(TypeError):
    fa.flash_attention(q.half(), torch.zeros(1, 1, 8, 16).half(),
                       torch.zeros(1, 1, 8, 16).half())
  with pytest.raises(ValueError, match="at least one key"):
    fa.flash_attention(q, torch.zeros(1, 1, 0, 16), torch.zeros(1, 1, 0, 16))
  assert fa.flash_attention.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_strided_views_with_out_match_the_contiguous_call(dtype):
  """q, k, v as transposed views of (B, S, H, D) buffers and ``out=`` a view
  of one, as models/attention.py passes them: the same result as the
  contiguous call, written into the caller's buffer and returned."""
  b, h, hkv, s, d = 2, 4, 2, 96, 32
  rng = np.random.default_rng(21)
  qb, kb, vb = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                 .astype(np.float32)).to(dtype)
                for n in (h, hkv, hkv))
  q, k, v = (t.transpose(1, 2) for t in (qb, kb, vb))
  assert not q.is_contiguous()
  want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, window=40)
  buf = torch.full((b, s, h, d), float("nan"), dtype=dtype)
  got = ops.flash_attention(q, k, v, causal=True, window=40,
                            out=buf.transpose(1, 2))
  assert got.data_ptr() == buf.data_ptr()
  torch.testing.assert_close(buf.transpose(1, 2), want, rtol=0, atol=0)
  with pytest.raises(ValueError, match="out must be"):
    fa.flash_attention(q, k, v, out=torch.empty(b, h, s, d + 1, dtype=dtype))
