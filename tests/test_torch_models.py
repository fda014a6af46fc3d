"""The port's dense LM layers and model against the reference, on the CPU.

The same weights (the reference's ``zoo.init`` tree, carried over by
``convert.from_reference``) and the same numpy inputs go through both
packages, at ``smoke_config()`` for the four dense architectures and
chameleon's VLM backbone (qk-norm), in f32 and in bf16.  The reference's Pallas arm runs in interpret mode, as its own
tests run it on the CPU.

Tolerances: f32 rtol/atol 1e-4 (the summation order differs between XLA's
and PyTorch's CPU kernels).  bf16: 8e-3 (one bf16 ulp at magnitude ≤ 1)
where the function rounds once at its end (``rms_norm``, ``rope``); 2e-2
where products round to bf16 along the way (``mlp``, ``attention``, the
model), the reference's own bf16 tolerance for its prefill/decode
consistency test (tests/test_models.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen2.5-3b", "granite-8b", "h2o-danube-1.8b",
         "chameleon-34b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 24   # S > 16: h2o-danube's smoke window masks inside the prefill


def _tol(dtype, *, rounds_once=False):
  if dtype == "f32":
    return dict(rtol=1e-4, atol=1e-4)
  return dict(rtol=8e-3, atol=8e-3) if rounds_once else dict(rtol=2e-2,
                                                             atol=2e-2)


def _cache_tol(cfg, dtype, want):
  """A qk-norm config's bf16 k rows are rounded at the norm (over hd 16 at
  smoke size) and again at RoPE, from a residual stream that differs by a
  bf16 ulp between the packages: a leaf is held to rtol 2e-2 and an atol
  of the larger of 2e-2 and 2.5e-2 of its largest magnitude, the hybrid
  cache's rule (tests/test_torch_hybrid.py)."""
  if dtype == "f32" or not cfg.qk_norm:
    return _tol(dtype)
  return dict(rtol=2e-2,
              atol=max(2e-2, 2.5e-2 * float(np.abs(_np(want)).max())))


def _cfgs(arch, dtype):
  jd, td = DTYPES[dtype]
  return (jconfigs.get_config(arch, smoke=True).replace(dtype=jd),
          tconfigs.get_config(arch, smoke=True).replace(dtype=td))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
      x, jax.Array) else x.float().numpy()


def _pair(a, dtype):
  """One numpy array as a reference array and a port tensor of ``dtype``."""
  jd, td = DTYPES[dtype]
  return jnp.asarray(a, jd), torch.from_numpy(np.array(a, np.float32)).to(td)


def _tree(arch, dtype, key=0):
  jcfg, tcfg = _cfgs(arch, dtype)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  tree = jax.tree.map(np.asarray, jparams)
  return jcfg, tcfg, jparams, tree


def _layer(tree, i=0):
  return jax.tree.map(lambda a: a[i], tree["blocks"])


def _torch_params(d):
  return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_rope(dtype):
  rng = np.random.default_rng(0)
  x = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
  scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
  jx, tx = _pair(x, dtype)
  got = tcm.rms_norm(tx, torch.from_numpy(scale), 1e-5)
  want = jcm.rms_norm(jx, jnp.asarray(scale), 1e-5)
  assert got.dtype == tx.dtype
  np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype,
                                                         rounds_once=True))
  pos = rng.integers(0, 4096, (B, S)).astype(np.int32)
  for theta in (10000.0, 1000000.0):
    got = tcm.rope(tx, torch.from_numpy(pos), theta)
    want = jcm.rope(jx, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want),
                               **_tol(dtype, rounds_once=True))
  np.testing.assert_array_equal(
      tcm.rope_freqs(8, 10000.0),
      1.0 / (10000.0 ** (np.arange(0, 8, dtype=np.float32) / 8)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
  """Mean and variance in f32, the result cast back (rounds once)."""
  rng = np.random.default_rng(11)
  x = (rng.standard_normal((B, S, 64)) * 3 + 1.5).astype(np.float32)
  scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
  bias = rng.standard_normal(64).astype(np.float32) * 0.1
  jx, tx = _pair(x, dtype)
  got = tcm.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                       1e-5)
  want = jcm.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 1e-5)
  assert got.dtype == tx.dtype
  np.testing.assert_allclose(_np(got), _np(want),
                             **_tol(dtype, rounds_once=True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, gated):
  jcfg, tcfg = _cfgs("tinyllama-1.1b", dtype)
  p = jax.tree.map(np.asarray, jmlp.mlp_params(jax.random.PRNGKey(1), jcfg,
                                               gated=gated))
  x = np.random.default_rng(1).standard_normal((B, S, 64)).astype(np.float32)
  jx, tx = _pair(x, dtype)
  got = tmlp.mlp(_torch_params(p), tcfg, tx)
  want = jmlp.mlp(jax.tree.map(jnp.asarray, p), jcfg, jx)
  assert got.dtype == tcfg.dtype
  np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_on_both_impls(arch, dtype):
  jcfg, tcfg, _, tree = _tree(arch, dtype)
  p = _layer(tree)["attn"]
  if jcfg.qkv_bias:  # zeros at init: give the biases values
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
             if k.startswith("b") else v) for k, v in p.items()}
  x = np.random.default_rng(3).standard_normal(
      (B, S, jcfg.d_model)).astype(np.float32)
  pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
  jx, tx = _pair(x, dtype)
  jp = jax.tree.map(jnp.asarray, p)
  for impl in ("pallas", "xla"):
    want, wkv = jattn.attention(jp, jcfg, jx, jnp.asarray(pos),
                                mode="prefill", impl=impl)
    got, gkv = tattn.attention(_torch_params(p), tcfg, tx,
                               torch.from_numpy(pos), mode="prefill",
                               impl=impl)
    assert got.dtype == tcfg.dtype and gkv["k"].shape == wkv["k"].shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    for name in ("k", "v"):
      np.testing.assert_allclose(_np(gkv[name]), _np(wkv[name]),
                                 **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,smax,cache_len", [
    ("tinyllama-1.1b", 32, 9),       # part-filled cache
    ("qwen2.5-3b", 32, 31),          # the last free row
    ("h2o-danube-1.8b", 16, 20),     # window-sized ring: wraps to row 4
    ("h2o-danube-1.8b", 32, 25),     # cache past the window: window mask
])
def test_attention_decode(arch, smax, cache_len, dtype):
  jcfg, tcfg, _, tree = _tree(arch, dtype)
  p = _layer(tree)["attn"]
  rng = np.random.default_rng(smax + cache_len)
  x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
  kc = rng.standard_normal((B, smax, jcfg.n_kv_heads, jcfg.hd)).astype(
      np.float32)
  vc = rng.standard_normal(kc.shape).astype(np.float32)
  pos = np.full((B, 1), cache_len, np.int32)
  jx, tx = _pair(x, dtype)
  (jk, tk), (jv, tv) = _pair(kc, dtype), _pair(vc, dtype)
  want, wc = jattn.attention(
      jax.tree.map(jnp.asarray, p), jcfg, jx, jnp.asarray(pos), mode="decode",
      layer_cache={"k": jk, "v": jv}, cache_len=jnp.asarray(cache_len,
                                                            jnp.int32))
  got, gc = tattn.attention(
      _torch_params(p), tcfg, tx, torch.from_numpy(pos), mode="decode",
      layer_cache={"k": tk, "v": tv},
      cache_len=torch.tensor(cache_len, dtype=torch.int32))
  np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
  for name in ("k", "v"):
    np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **_tol(dtype))
  row = cache_len % smax
  assert not np.array_equal(_np(gc["k"])[:, row], kc[:, row])  # written
  np.testing.assert_array_equal(np.delete(_np(gc["k"]), row, axis=1),
                                np.delete(_np(_pair(kc, dtype)[1]), row,
                                          axis=1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_prefill_logits_and_cache(arch, dtype):
  jcfg, tcfg, jparams, tree = _tree(arch, dtype)
  model = convert.from_reference(tree, tcfg, device="cpu")
  toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S)).astype(
      np.int32)
  tt = torch.from_numpy(toks)
  for impl in ("pallas", "xla"):
    wl, wc, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             mode="prefill", impl=impl)
    gl, gc, _ = tzoo.forward(model, tcfg, {"tokens": tt}, mode="prefill",
                             impl=impl)
    assert gl.shape == (B, 1, ttf.padded_vocab(tcfg)) == wl.shape
    assert gl.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
    assert int(gc["len"]) == int(wc["len"]) == S
    for name in ("k", "v"):
      assert gc[name].shape == wc[name].shape
      np.testing.assert_allclose(_np(gc[name]), _np(wc[name]),
                                 **_cache_tol(tcfg, dtype, wc[name]))
  # train mode: every position, forward only
  wl, _, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          mode="train")
  gl, gcache, _ = tzoo.forward(model, tcfg, {"tokens": tt}, mode="train")
  assert gcache is None and gl.shape == wl.shape
  np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_from_reference(arch):
  jcfg, tcfg, jparams, tree = _tree(arch, "f32", key=5)
  model = convert.from_reference(tree, tcfg, device="cpu")
  assert tzoo.param_count(model) == jzoo.param_count(jparams)
  assert len(model.blocks) == jcfg.n_layers
  for i, block in enumerate(model.blocks):
    for name, t in block.attn.named_parameters():
      np.testing.assert_array_equal(
          t.numpy(), tree["blocks"]["attn"][name][i])
    for name, t in block.mlp.named_parameters():
      np.testing.assert_array_equal(t.numpy(), tree["blocks"]["mlp"][name][i])
    np.testing.assert_array_equal(block.ln1_norm_scale.numpy(),
                                  tree["blocks"]["ln1_norm_scale"][i])
  np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
  np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
  assert all(p.dtype == torch.float32 for p in model.parameters())
  assert not any(p.requires_grad for p in model.parameters())
  # a tree of the wrong depth is refused
  with pytest.raises(ValueError, match="layers"):
    convert.from_reference(tree, tcfg.replace(n_layers=3), device="cpu")


def test_other_families_are_refused():
  """Every architecture of the reference's registry is ported; a family
  the zoo does not know is refused."""
  assert tconfigs.list_archs() == jconfigs.list_archs()
  cfg = tconfigs.get_config("tinyllama-1.1b", smoke=True).replace(
      family="rnn")
  with pytest.raises(ValueError, match="rnn"):
    tzoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
  with pytest.raises(ValueError, match="rnn"):
    tzoo.init_cache(cfg, 1, 8, device="cpu")
  with pytest.raises(ValueError, match="not encdec"):
    ttf.TransformerLM(cfg.replace(family="encdec"), {"blocks": []})


def test_init_draws_from_the_generator():
  cfg = tconfigs.get_config("tinyllama-1.1b", smoke=True)
  a = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
  b = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
  c = tzoo.init(cfg, torch.Generator().manual_seed(4), device="cpu")
  jcfg = jconfigs.get_config("tinyllama-1.1b", smoke=True)
  assert tzoo.param_count(a) == jzoo.param_count(
      jzoo.init(jcfg, jax.random.PRNGKey(0)))
  for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
    assert torch.equal(pa, pb)
    assert pa.shape == pc.shape
  assert not torch.equal(a.embed, c.embed)
  cache = tzoo.init_cache(cfg, 2, 40, device="cpu")
  assert cache["k"].shape == (cfg.n_layers, 2, 40, cfg.n_kv_heads, cfg.hd)
  assert cache["k"].dtype == cfg.dtype and int(cache["len"]) == 0
