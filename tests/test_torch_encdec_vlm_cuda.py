"""The enc-dec and VLM serving paths' kernels on the card: K3 at the four
attention shapes the seamless and chameleon prefills give it, K1's addnorm
at chameleon's VQ shape, and the smoke models' launch counts.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips with a reason where there is none.  The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_encdec_vlm_cuda.py

Tolerances: K3 bf16 atol 3e-2 against its plain version (the reference
kernel test's own; tests/test_torch_flash_attention_cuda.py); K1 addnorm
rtol 1e-5 / atol 1e-4 (tests/test_torch_kernels_cuda.py: the FMA order
differs), scaled by the 256-term sums here to atol 1e-3 (squared
distances near 512); token ids exactly; the pipeline's forward atol 1e-5
against the sequential layers (f32, tanh outputs in [-1, 1]) and its
gradients rtol 1e-4 with an atol of 1e-5 of their largest magnitude (the
shards' GEMMs sum rows in other orders).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

fa = importlib.import_module("repro_torch.kernels.flash_attention")
sm = importlib.import_module("repro_torch.kernels.semiring_mmo")
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

# (B, H, Hkv, Sq, Skv, D, causal, window)
SERVED = [
    (4, 16, 16, 4096, 4096, 64, False, None),   # seamless encoder
    (4, 16, 16, 256, 4096, 64, False, None),    # seamless cross-attention
    (4, 16, 16, 256, 256, 64, True, None),      # seamless decoder
    (4, 64, 8, 2048, 2048, 128, True, None),    # chameleon-34b
]


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


@pytest.mark.parametrize("case", SERVED, ids=str)
def test_k3_at_the_served_shapes_matches_plain(cuda, case):
  b, h, hkv, sq, skv, d, causal, window = case
  g = torch.Generator().manual_seed(sum(case[:6]))
  q = torch.randn(b, h, sq, d, generator=g).to(cuda, torch.bfloat16)
  k, v = (torch.randn(b, hkv, skv, d, generator=g).to(cuda, torch.bfloat16)
          for _ in range(2))
  before = fa.flash_attention.launches
  got = ops.flash_attention(q, k, v, causal=causal, window=window)
  torch.cuda.synchronize()
  assert fa.flash_attention.launches == before + 1
  want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
  torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)


def test_k3_reads_cross_kv_views_as_they_are(cuda):
  """The decoder's cross K/V are layer slices of one (B, Skv, L, 2, KV,
  hd) product (``encdec.cross_kv``): K3 reads them through strided views
  and writes a view of a (B, Sq, H, hd) buffer, with the contiguous
  call's bits."""
  from repro_torch.models import attention as attn
  b, sq, skv, n, h, d = 2, 100, 600, 3, 4, 64
  g = torch.Generator().manual_seed(3)
  kv = torch.randn(b, skv, n, 2, h, d, generator=g).to(cuda, torch.bfloat16)
  kv = kv.permute(2, 3, 0, 1, 4, 5)                    # (L, 2, B, Skv, H, hd)
  qb = torch.randn(b, sq, h, d, generator=g).to(cuda, torch.bfloat16)
  for layer in range(n):
    k, v = kv[layer, 0], kv[layer, 1]
    attn._check_override(k, v)                         # takes them: no raise
    want = fa.flash_attention(qb.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), causal=False)
    buf = torch.full_like(qb, float("nan"))
    before = fa.flash_attention.launches
    ops.flash_attention(qb.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=False,
                        out=buf.transpose(1, 2))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert torch.equal(buf.transpose(1, 2), want)
  odd = torch.zeros(b, skv, h, d + 8, device=cuda,
                    dtype=torch.bfloat16)[..., 1:d + 1]
  with pytest.raises(ValueError, match="kv_override"):
    attn._check_override(odd, odd)


def test_k1_addnorm_at_the_vq_shape(cuda):
  """chameleon's image half: 4 × 1024 patches of 256 against an 8192-code
  codebook, one K1 launch; the distances against K1's plain version and
  the ids against the drawn codes and a float64 brute force."""
  from repro_torch.models import vlm
  g = torch.Generator(device=cuda).manual_seed(0)
  codebook = torch.randn(8192, 256, generator=g, device=cuda)
  codes = torch.randint(0, 8192, (4, 1024), generator=g, device=cuda)
  patches = codebook[codes] + 0.05 * torch.randn(4, 1024, 256, generator=g,
                                                 device=cuda)
  before = sm.semiring_mmo.launches
  ids = vlm.vq_tokenize(patches, codebook, backend="pallas")
  torch.cuda.synchronize()
  assert sm.semiring_mmo.launches == before + 1
  assert ids.dtype == torch.int32 and torch.equal(ids.long(), codes)
  flat = patches.reshape(-1, 256)
  got = ops.semiring_mmo(flat, codebook.T, op="addnorm")
  want = sm.semiring_mmo_plain(flat[None], codebook.T.contiguous()[None],
                               op="addnorm")[0]
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
  f64 = flat.double()
  cb = codebook.double()
  d2 = ((f64 * f64).sum(-1, keepdim=True) - 2 * f64 @ cb.T
        + (cb * cb).sum(-1)[None])
  assert torch.equal(d2.argmin(-1).reshape(4, 1024), ids.long())


def test_smoke_models_launch_k3_per_attention_layer(cuda):
  """seamless smoke (2 + 2 layers): K3 once per encoder layer and twice
  per decoder layer in a 'pallas' generate, never in the decode;
  chameleon smoke: once per layer.  The 'xla' engine launches none."""
  from repro_torch import configs
  from repro_torch.launch.serve import Engine
  from repro_torch.models import zoo
  for arch, want in (("seamless-m4t-large-v2", 6), ("chameleon-34b", 2)):
    cfg = configs.get_config(arch, smoke=True).replace(dtype=torch.float32)
    model = zoo.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (2, 12), dtype=np.int32)
    src = (rng.standard_normal((2, cfg.src_len, cfg.d_model)).astype(
        np.float32) if cfg.family == "encdec" else None)
    before = fa.flash_attention.launches
    got = Engine(cfg, model, max_len=32, device=cuda).generate(
        prompts, 5, src_embeds=src)
    assert fa.flash_attention.launches == before + want, arch
    assert got.shape == (2, 5) and ((got >= 0) & (got < cfg.vocab)).all()
    before = fa.flash_attention.launches
    Engine(cfg, model, max_len=32, impl="xla", device=cuda).generate(
        prompts, 5, src_embeds=src)
    assert fa.flash_attention.launches == before, arch


def test_pipeline_on_a_virtual_mesh_of_the_card(cuda):
  """The GPipe schedule on a (4, 2) mesh of eight shards of the card
  against the sequential layers, forward and gradients (f32, D 256)."""
  from repro_torch.launch.mesh import make_host_mesh
  from repro_torch.models import pipeline
  mesh = make_host_mesh(devices=[cuda] * 8, axis_names=("stage", "data"))
  g = torch.Generator(device=cuda).manual_seed(2)
  w = (torch.randn(12, 256, 256, generator=g, device=cuda) / 16
       ).requires_grad_(True)
  x = torch.randn(8, 64, 256, generator=g, device=cuda)

  def stage_fn(ws, h):
    for layer in ws:
      h = torch.tanh(h @ layer)
    return h
  with _no_tf32():
    y = pipeline.pipeline(stage_fn, mesh, x_spec=(None, "data"))(
        pipeline.split_stages(w, 4), x)
    (gw,) = torch.autograd.grad((y ** 2).sum(), (w,))
    ref = stage_fn(w, x)
    (rw,) = torch.autograd.grad((ref ** 2).sum(), (w,))
  torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
  torch.testing.assert_close(gw, rw, rtol=1e-4,
                             atol=1e-5 * float(rw.abs().max()))


class _no_tf32:
  """f32 matmuls without TF32 for the block (restored after)."""

  def __enter__(self):
    self.saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

  def __exit__(self, *exc):
    torch.backends.cuda.matmul.allow_tf32 = self.saved
