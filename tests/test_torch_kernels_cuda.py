"""K1's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: bit-exact for the min/max rings and orand (f32, and bf16 where
the output keeps bf16: both round once at the store), rtol 1e-5 / atol 1e-4
for mma (3×TF32 on the tensor cores sums in another order, with a split
residue below f32's rounding) and addnorm (the kernel's FMA order differs),
3e-2 for bf16 mma and addnorm.
"""
import importlib
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.semiring import ALL_OPS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")

MMO_SHAPES = [(128, 128, 128), (64, 200, 96), (13, 7, 5), (256, 384, 128),
              (1, 128, 1)]
EXACT = ("minplus", "maxplus", "minmul", "maxmul", "minmax", "maxmin",
         "orand")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def assert_parity(got, want, op, *, bf16=False):
  got = got.float().cpu().numpy().astype(np.float64)
  want = want.float().cpu().numpy().astype(np.float64)
  if bf16:
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
  elif op in EXACT:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _operands(op, shape, device, batch=1, seed=1):
  m, k, n = shape
  g = torch.Generator().manual_seed(seed)
  a = torch.randn(batch, m, k, generator=g)
  b = torch.randn(batch, k, n, generator=g)
  c = torch.randn(batch, m, n, generator=g)
  if op == "orand":
    a, b, c = a > 0.8, b > 0.8, c > 1.5
  return a.to(device), b.to(device), c.to(device)


@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("shape", MMO_SHAPES)
def test_kernel_matches_plain(cuda, op, shape):
  a, b, c = _operands(op, shape, cuda)
  before = sm.semiring_mmo.launches
  got = sm.semiring_mmo(a, b, c, op=op)
  torch.cuda.synchronize()
  assert sm.semiring_mmo.launches == before + 1
  assert_parity(got, sm.semiring_mmo_plain(a, b, c, op=op), op)


@pytest.mark.parametrize("op", ALL_OPS)
def test_kernel_per_request_k_valid_matches_plain(cuda, op):
  """Lanes past each request's k_valid are masked to the ⊕-identity —
  with real data behind them, so the mask itself is what is checked."""
  a, b, c = _operands(op, (70, 150, 90), cuda, batch=4, seed=2)
  kv = torch.tensor([150, 64, 17, 0], dtype=torch.int32, device=cuda)
  got = sm.semiring_mmo(a, b, c, op=op, k_valid=kv)
  assert_parity(got, sm.semiring_mmo_plain(a, b, c, op=op, k_valid=kv), op)


@pytest.mark.parametrize("op", ["mma", "minplus", "maxmin", "addnorm"])
def test_kernel_bf16_matches_plain(cuda, op):
  g = torch.Generator().manual_seed(4)
  a = torch.randn(2, 64, 96, generator=g).to(cuda, torch.bfloat16)
  b = torch.randn(2, 96, 32, generator=g).to(cuda, torch.bfloat16)
  got = sm.semiring_mmo(a, b, op=op)
  want = sm.semiring_mmo_plain(a, b, op=op)
  assert got.dtype == want.dtype
  assert_parity(got, want, op, bf16=True)


def test_kernel_propagates_nan_like_torch_minimum(cuda):
  a = torch.ones(1, 8, 8, device=cuda)
  a[0, 3, 2] = float("nan")
  got = sm.semiring_mmo(a, a, a, op="minplus")
  want = sm.semiring_mmo_plain(a, a, a, op="minplus")
  assert torch.equal(torch.isnan(got), torch.isnan(want))
  assert bool(torch.isnan(got[0, 3]).any())


def test_batched_entry_point_launches_once(cuda):
  a, b, _ = _operands("minplus", (32, 40, 24), cuda, batch=6)
  before = sm.semiring_mmo.launches
  got = ops.semiring_mmo(a.reshape(2, 3, 32, 40), b.reshape(2, 3, 40, 24),
                         op="minplus", k_valid=40)
  assert sm.semiring_mmo.launches == before + 1
  assert_parity(got.reshape(6, 32, 24), sm.semiring_mmo_plain(a, b,
                                                              op="minplus"),
                "minplus")


def test_wrapper_refuses_non_contiguous_operands(cuda):
  a, b, _ = _operands("minplus", (16, 16, 16), cuda)
  with pytest.raises(ValueError, match="contiguous"):
    sm.semiring_mmo(a.transpose(1, 2), b, op="minplus")


def test_mma_f32_4096_cube_within_tolerance(cuda):
  """The main path's mma yardstick, 3×TF32 on the tensor cores, holds f32's
  tolerance at K = 4096."""
  g = torch.Generator().manual_seed(5)
  a = torch.randn(1, 4096, 4096, generator=g).to(cuda)
  b = torch.randn(1, 4096, 4096, generator=g).to(cuda)
  assert sm.tile_shape("mma", torch.float32, 1, 4096, 4096) == (128, 128)
  got = sm.semiring_mmo(a, b, op="mma")
  assert_parity(got, sm.semiring_mmo_plain(a, b, op="mma"), "mma")


def test_mma_ragged_k_valid_on_the_tensor_cores(cuda):
  """k_valid ending inside a 32-deep slab and inside an 8-deep k group, a
  frozen request, ragged M and N edges."""
  a, b, c = _operands("mma", (300, 1000, 200), cuda, batch=4, seed=6)
  kv = torch.tensor([1000, 517, 33, 0], dtype=torch.int32, device=cuda)
  got = sm.semiring_mmo(a, b, c, op="mma", k_valid=kv)
  assert_parity(got, sm.semiring_mmo_plain(a, b, c, op="mma", k_valid=kv),
                "mma")


def test_mma_non_finite_inputs_give_the_f32_pattern(cuda):
  """±inf and NaN operands: where the f32 terms are not all finite, the
  3×TF32 product takes their inf/NaN pattern (inf·x with x exact in TF32
  would otherwise meet a zero small part and give NaN)."""
  a, b, _ = _operands("mma", (150, 70, 90), cuda, seed=7)
  a[0, 3, 5] = float("inf")
  a[0, 10, 2] = float("-inf")
  a[0, 10, 9] = float("inf")   # +inf and -inf terms in row 10: NaN
  b[0, 4, 7] = float("nan")
  b[0, 6, 30] = float("inf")
  a[0, 120, 6] = 0.0           # 0 · inf: NaN in (120, 30)
  b[0, 5, :] = torch.round(b[0, 5, :])  # exact in TF32: small part 0
  got = sm.semiring_mmo(a, b, op="mma")
  want = sm.semiring_mmo_plain(a, b, op="mma")
  for pattern in (torch.isnan, torch.isposinf, torch.isneginf):
    assert torch.equal(pattern(got), pattern(want)), pattern.__name__
  assert_parity(got, want, "mma")


# (M, K, N) and the square tile each takes: 4096² covers ≥ 2 waves of
# 128×128 CTAs, 256² and 130×133 do not; the odd sizes' rows are not
# 16-byte multiples, so every slab takes the threads' fill
INSTANCE_CASES = [((4096, 48, 4096), 128), ((4097, 61, 4095), 128),
                  ((256, 300, 256), 64), ((130, 201, 133), 64)]


@pytest.mark.parametrize("shape,tile", INSTANCE_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("op", EXACT + ("addnorm",))
def test_cuda_core_instances_match_plain(cuda, op, shape, tile):
  m, k, n = shape
  a, b, c = _operands(op, shape, cuda, seed=8)
  assert sm.tile_shape(op, a.dtype, 1, m, n) == (tile, tile)
  got = sm.semiring_mmo(a, b, c, op=op)
  assert_parity(got, sm.semiring_mmo_plain(a, b, c, op=op), op)


@pytest.mark.parametrize("shape,tile", INSTANCE_CASES[::2],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("op", ["minplus", "maxmul", "orand"])
def test_cuda_core_instances_k_valid_mid_slab(cuda, op, shape, tile):
  """k_valid = 37 ends inside the third 16-deep slab: that slab takes the
  threads' fill with the ring's pads, the ones before it cp.async."""
  m, k, n = shape
  a, b, c = _operands(op, shape, cuda, seed=9)
  kv = torch.tensor([37], dtype=torch.int32, device=cuda)
  assert sm.tile_shape(op, a.dtype, 1, m, n) == (tile, tile)
  got = sm.semiring_mmo(a, b, c, op=op, k_valid=kv)
  assert_parity(got, sm.semiring_mmo_plain(a, b, c, op=op, k_valid=kv), op)


@pytest.mark.parametrize("shape,tile", INSTANCE_CASES[::2],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("op", ["minplus", "maxmin"])
def test_cuda_core_instances_bf16_bit_exact(cuda, op, shape, tile):
  """bf16 in and out: staged raw, widened once per fragment, rounded once
  at the store, as the plain version rounds."""
  m, k, n = shape
  a, b, c = (t.to(torch.bfloat16) for t in _operands(op, shape, cuda,
                                                     seed=10))
  assert sm.tile_shape(op, a.dtype, 1, m, n) == (tile, tile)
  got = sm.semiring_mmo(a, b, c, op=op)
  want = sm.semiring_mmo_plain(a, b, c, op=op)
  assert got.dtype == want.dtype == torch.bfloat16
  assert torch.equal(got, want)
