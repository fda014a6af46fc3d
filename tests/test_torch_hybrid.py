"""The port's hybrid LM (zamba2: SSM layers with one shared attention block)
against the reference, on the CPU.

The same weights (the reference's ``zoo.init`` tree, carried over by
``convert.from_reference``) and the same numpy tokens go through both
packages at zamba2-7b's ``smoke_config()``: 5 SSM layers, the shared block
every 2, so 2 applications and a tail layer.  The reference's Pallas arms
(K3 for the shared block, K4 for the SSM layers) run in interpret mode, as
its own tests run them on the CPU.

Tolerances: logits f32 rtol/atol 1e-4 and bf16 2e-2, those of the dense
and SSM model tests (tests/test_torch_models.py, tests/test_torch_ssm.py);
the caches the same in f32.  In bf16 the caches hold raw projections (conv
inputs, k and v) of a residual stream that has gone through up to 5 SSM
layers and 2 applications of the shared block, rounding to bf16 at other
places in the two packages: at magnitudes up to ~4, where a bf16 ulp is
1.6e-2, they differ by up to 5 ulps in the deepest layers (0.078 on these
inputs), so each bf16 cache leaf is held to rtol 2e-2 and an atol of the
larger of 2e-2 and 2.5e-2 of its largest magnitude (``_cache_tol``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.serve import seat_cache  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

ARCH = "zamba2-7b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 20   # S > chunk 8: three SSD chunks, the last one padded


def _tol(dtype):
  return (dict(rtol=1e-4, atol=1e-4) if dtype == "f32"
          else dict(rtol=2e-2, atol=2e-2))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
      x, jax.Array) else x.float().numpy()


def _models(dtype, key=0):
  jd, td = DTYPES[dtype]
  jcfg = jconfigs.get_config(ARCH, smoke=True).replace(dtype=jd)
  tcfg = tconfigs.get_config(ARCH, smoke=True).replace(dtype=td)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  return jcfg, tcfg, jparams, model


def _tokens(vocab, s=S, seed=4):
  return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
      np.int32)


def _cache_tol(dtype, want):
  if dtype == "f32":
    return _tol(dtype)
  return dict(rtol=2e-2,
              atol=max(2e-2, 2.5e-2 * float(np.abs(_np(want)).max())))


def _assert_trees_close(got, want, dtype, path="cache"):
  if isinstance(want, dict):
    assert sorted(got) == sorted(want)
    for k in want:
      _assert_trees_close(got[k], want[k], dtype, f"{path}/{k}")
    return
  assert tuple(got.shape) == tuple(want.shape), path
  np.testing.assert_allclose(_np(got), _np(want), **_cache_tol(dtype, want),
                             err_msg=path)


def test_layout_of_the_published_and_smoke_configs():
  full = tconfigs.get_config(ARCH)
  assert thybrid.layout(full) == (6, 13)       # 78 layers in 13 groups
  assert full.n_layers - 6 * 13 == 3           # and a tail of 3
  assert thybrid.layout(tconfigs.get_config(ARCH, smoke=True)) == (2, 2)
  assert thybrid.layout(full.replace(hybrid_attn_every=0)) == (82, 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_cache_on_both_impls(dtype):
  jcfg, tcfg, jparams, model = _models(dtype)
  toks = _tokens(jcfg.vocab)
  for impl in ("pallas", "xla"):
    wl, wc, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             mode="prefill", impl=impl)
    with torch.inference_mode():
      gl, gc, ga = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
          toks)}, mode="prefill", impl=impl)
    assert gl.shape == wl.shape and gl.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
    assert gc["attn"]["k"].shape == (2, B, S, tcfg.n_kv_heads, tcfg.hd)
    _assert_trees_close(gc, wc, dtype)
    assert float(ga) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_logits(dtype):
  jcfg, tcfg, jparams, model = _models(dtype)
  toks = _tokens(jcfg.vocab, seed=5)
  wl, wcache, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                               mode="train")
  gl, gcache, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
      toks)}, mode="train")
  assert wcache is None and gcache is None
  np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
  """Prefill, the cache seated at max_len (the SSM state as it is, each
  application's KV rows at the front), then three decode steps: logits and
  the whole cache against the reference's."""
  jcfg, tcfg, jparams, model = _models(dtype, key=2)
  s, max_len, steps = 12, 24, 3
  toks = _tokens(jcfg.vocab, s + steps, seed=6)
  _, wc, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                          mode="prefill")
  full = jzoo.init_cache(jcfg, B, max_len)
  wc = jax.tree.map(lambda f, g: g.astype(f.dtype) if f.shape == g.shape
                    else jnp.pad(g, [(0, a - b) for a, b in zip(
                        f.shape, g.shape)]).astype(f.dtype), full, wc)
  with torch.inference_mode():
    _, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
        toks[:, :s])}, mode="prefill")
    ssm_before = gc["ssm"]["ssm"]
    gc = seat_cache(tcfg, gc, max_len, "cpu")
    assert gc["ssm"]["ssm"] is ssm_before   # seated as it is
    kbuf = gc["attn"]["k"]
    for t in range(s, s + steps):
      wl, wc, _ = jzoo.forward(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               mode="decode", cache=wc)
      gl, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
          toks[:, t:t + 1])}, mode="decode", cache=gc)
      np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
      _assert_trees_close(gc, wc, dtype)
  assert gc["attn"]["k"] is kbuf            # written in place
  assert int(gc["len"]) == s + steps


def test_remat_full_equals_none():
  """remat='full' recomputes each group and tail layer in the backward: the
  same logits and the same gradients as keeping everything."""
  _, tcfg, _, model = _models("f32")
  toks = torch.from_numpy(_tokens(tcfg.vocab, seed=7))
  params = [p for p in model.parameters()]
  out = {}
  for remat in ("none", "full", "dots"):
    for p in params:
      p.requires_grad_(True)
      p.grad = None
    logits, _, _ = tzoo.forward(model, tcfg, {"tokens": toks}, mode="train",
                                remat=remat)
    logits.float().square().mean().backward()
    out[remat] = (logits.detach(), [p.grad.clone() for p in params])
  for remat in ("full", "dots"):
    assert torch.equal(out[remat][0], out["none"][0])
    for a, b in zip(out[remat][1], out["none"][1]):
      torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
  shared = dict(model.shared.named_parameters())
  assert shared["attn.wq"].grad is not None     # one set, every application
  with pytest.raises(ValueError, match="remat"):
    tzoo.forward(model, tcfg, {"tokens": toks}, mode="train", remat="all")


def test_convert_keeps_the_shared_block_unsplit():
  jcfg, tcfg, jparams, model = _models("f32", key=5)
  tree = jax.tree.map(np.asarray, jparams)
  assert tzoo.param_count(model) == jzoo.param_count(jparams)
  assert len(model.blocks) == jcfg.n_layers
  for name, t in model.shared.named_parameters():
    node = tree["shared"]
    for part in name.split("."):
      node = node[part]
    np.testing.assert_array_equal(t.numpy(), node)
  for i, layer in enumerate(model.blocks):
    np.testing.assert_array_equal(layer.ssm.A_log.numpy(),
                                  tree["blocks"]["ssm"]["A_log"][i])
  ptree = tzoo.param_tree(model)
  assert sorted(ptree) == sorted(tree)
  assert sorted(ptree["shared"]) == sorted(tree["shared"])
  with pytest.raises(ValueError, match="layers"):
    convert.from_reference(tree, tcfg.replace(n_layers=4), device="cpu")


def test_init_and_cache_match_the_reference_layout():
  jcfg = jconfigs.get_config(ARCH, smoke=True)
  tcfg = tconfigs.get_config(ARCH, smoke=True)
  model = tzoo.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
  assert isinstance(model, thybrid.HybridLM)
  assert tzoo.param_count(model) == jzoo.param_count(
      jzoo.init(jcfg, jax.random.PRNGKey(0)))
  got = tzoo.init_cache(tcfg, 3, 40, device="cpu")
  want = jzoo.init_cache(jcfg, 3, 40)

  def shapes(tree):
    return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}
  assert shapes(got) == shapes(want)
  assert got["attn"]["k"].dtype == tcfg.dtype and int(got["len"]) == 0
