"""The port's VLM (chameleon) against the reference, on the CPU.

``vq_tokenize`` (nearest-codebook search as SIMD²'s addnorm) on the
'vector', 'xla' and 'pallas' arms (K1's plain version here) against the
reference's and against a float64 brute force, as tests/test_models.py
does it; ``fuse_streams``; and the chameleon smoke model (the dense
backbone with ``qk_norm``, 2 layers, 4 heads over 2 kv heads of 16) fed
token ids and precomputed (B, S, D) embeddings, with the same weights
(``convert.from_reference``) and numpy inputs as the reference.

Tolerances: token ids exactly (the drawn patches sit 0.01–0.05 from their
code and far from any other); logits f32 rtol/atol 1e-4, bf16 2e-2, those
of the dense model tests (tests/test_torch_models.py); one f32 train step's
loss and grad norm rtol 1e-5 (tests/test_torch_train.py); greedy tokens
under the reference's near-tie rule with the LM head scaled 8×
(tests/test_torch_serve.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import Engine as JEngine  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "chameleon-34b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 16
BACKENDS = ("vector", "xla", "pallas")


def _tol(dtype):
  return (dict(rtol=1e-4, atol=1e-4) if dtype == "f32"
          else dict(rtol=2e-2, atol=2e-2))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
      x, jax.Array) else x.detach().float().numpy()


def _patches(n_codes, d, shape, noise, seed):
  """A codebook and patches that are drawn codes plus small noise; returns
  them with the drawn codes."""
  rng = np.random.default_rng(seed)
  codebook = rng.standard_normal((n_codes, d)).astype(np.float32)
  codes = rng.integers(0, n_codes, shape)
  patches = (codebook[codes] + noise * rng.standard_normal(
      shape + (d,))).astype(np.float32)
  return codebook, patches, codes


def _brute_force(patches, codebook):
  flat = patches.reshape(-1, patches.shape[-1]).astype(np.float64)
  d2 = ((flat[:, None, :] - codebook.astype(np.float64)[None]) ** 2).sum(-1)
  return d2.argmin(-1).reshape(patches.shape[:-1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [(64, 16, (2, 10), 0.01, 0),
                                  (512, 64, (3, 40), 0.05, 1),
                                  (256, 256, (64,), 0.05, 2)], ids=str)
def test_vq_tokenize_matches_reference_and_brute_force(backend, case):
  n_codes, d, shape, noise, seed = case
  codebook, patches, codes = _patches(n_codes, d, shape, noise, seed)
  got = tvlm.vq_tokenize(torch.from_numpy(patches),
                         torch.from_numpy(codebook), backend=backend)
  want = np.asarray(jvlm.vq_tokenize(jnp.asarray(patches),
                                     jnp.asarray(codebook), backend=backend))
  assert got.dtype == torch.int32 and tuple(got.shape) == shape
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(got.numpy(), _brute_force(patches, codebook))
  np.testing.assert_array_equal(got.numpy(), codes)


def test_vq_tokenize_default_backend_is_auto():
  """'auto' with no cost table resolves to 'xla', as the reference's
  default does."""
  codebook, patches, _ = _patches(64, 16, (2, 10), 0.01, 3)
  got = tvlm.vq_tokenize(torch.from_numpy(patches),
                         torch.from_numpy(codebook))
  want = tvlm.vq_tokenize(torch.from_numpy(patches),
                          torch.from_numpy(codebook), backend="xla")
  assert torch.equal(got, want)


@pytest.mark.parametrize("dtypes", [(np.int32, np.int32),
                                    (np.int64, np.int32)], ids=str)
def test_fuse_streams_matches_reference(dtypes):
  rng = np.random.default_rng(4)
  text = rng.integers(0, 32768, (2, 7)).astype(dtypes[0])
  image = rng.integers(0, 8192, (2, 5)).astype(dtypes[1])
  got = tvlm.fuse_streams(torch.from_numpy(text), torch.from_numpy(image),
                          32768)
  want = np.asarray(jvlm.fuse_streams(jnp.asarray(text), jnp.asarray(image),
                                      32768))
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(got[:, :5].numpy(), image + 32768)
  np.testing.assert_array_equal(got[:, 5:].numpy(), text)


def _models(dtype, key=0, head_scale=1):
  jd, td = DTYPES[dtype]
  jcfg = jconfigs.get_config(ARCH, smoke=True).replace(dtype=jd)
  tcfg = tconfigs.get_config(ARCH, smoke=True).replace(dtype=td)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  jparams["lm_head"] = jparams["lm_head"] * head_scale
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  return jcfg, tcfg, jparams, model


def test_the_model_carries_qk_norm_scales():
  jcfg, tcfg, jparams, model = _models("f32", key=5)
  assert tcfg.qk_norm and tcfg.family == "vlm"
  tree = jax.tree.map(np.asarray, jparams)
  assert tzoo.param_count(model) == jzoo.param_count(jparams)
  for i, block in enumerate(model.blocks):
    for name in ("q_norm_scale", "k_norm_scale"):
      np.testing.assert_array_equal(getattr(block.attn, name).numpy(),
                                    tree["blocks"]["attn"][name][i])
  assert sorted(tzoo.param_tree(model)["blocks"][0]["attn"]) == sorted(
      tree["blocks"]["attn"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inputs", ["tokens", "embeds"])
def test_logits_from_tokens_and_embeddings(inputs, dtype):
  """Train and prefill logits (and the prefill cache) on both arms, fed
  token ids or (B, S, D) embeddings (``batch['src_embeds']``, the
  reference's modality-stub path)."""
  jcfg, tcfg, jparams, model = _models(dtype)
  rng = np.random.default_rng(6)
  toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
  jb = {"tokens": jnp.asarray(toks)}
  tb = {"tokens": torch.from_numpy(toks)}
  if inputs == "embeds":
    emb = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jb["src_embeds"] = jnp.asarray(emb)
    tb["src_embeds"] = torch.from_numpy(emb)
  for mode in ("train", "prefill"):
    for impl in ("pallas", "xla"):
      wl, wc, _ = jzoo.forward(jparams, jcfg, jb, mode=mode, impl=impl)
      with torch.inference_mode():
        gl, gc, _ = tzoo.forward(model, tcfg, tb, mode=mode, impl=impl)
      assert gl.shape == wl.shape and gl.dtype == tcfg.dtype
      np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
      if mode == "prefill":
        for name in ("k", "v"):
          np.testing.assert_allclose(_np(gc[name]), _np(wc[name]),
                                     **_tol(dtype))
  if inputs == "embeds":  # the embeddings, not the tokens, were read
    with torch.inference_mode():
      a, _, _ = tzoo.forward(model, tcfg, tb, mode="train")
      b, _, _ = tzoo.forward(model, tcfg, {"tokens": tb["tokens"]},
                             mode="train")
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
  jcfg, tcfg, jparams, model = _models(dtype, key=2)
  s, max_len, steps = 10, 20, 3
  toks = np.random.default_rng(7).integers(0, jcfg.vocab,
                                           (B, s + steps)).astype(np.int32)
  _, wc, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                          mode="prefill")
  full = jzoo.init_cache(jcfg, B, max_len)
  wc = jax.tree.map(lambda f, g: g.astype(f.dtype) if f.shape == g.shape
                    else jnp.pad(g, [(0, a - b) for a, b in zip(
                        f.shape, g.shape)]).astype(f.dtype), full, wc)
  with torch.inference_mode():
    _, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
        toks[:, :s])}, mode="prefill")
    gc = tserve.seat_cache(tcfg, gc, max_len, "cpu")
    for t in range(s, s + steps):
      wl, wc, _ = jzoo.forward(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               mode="decode", cache=wc)
      gl, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
          toks[:, t:t + 1])}, mode="decode", cache=gc)
      np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))


def test_engine_serves_a_fused_stream_as_the_reference_engine():
  """Image ids tokenized by K1 (its plain version), fused ahead of text,
  served greedily: the port's engine on both arms against the reference's
  engine on the same fused prompt (f32, the near-tie rule with gap
  1e-4)."""
  jcfg, tcfg, jparams, model = _models("f32", key=3, head_scale=8)
  codebook, patches, codes = _patches(64, 16, (B, 6), 0.01, 8)
  image = tvlm.vq_tokenize(torch.from_numpy(patches),
                           torch.from_numpy(codebook), backend="pallas")
  np.testing.assert_array_equal(image.numpy(), codes)
  text = torch.from_numpy(np.random.default_rng(9).integers(
      0, 256, (B, 6)).astype(np.int32))
  prompts = tvlm.fuse_streams(text, image, 256).numpy()
  assert prompts.max() < jcfg.vocab
  want = JEngine(jcfg, jparams, max_len=32).generate(prompts, 6)
  n = want.shape[1]
  ok = np.full(B, n)
  ctx = jnp.asarray(prompts, jnp.int32)
  for t in range(n):
    logits, _, _ = jzoo.forward(jparams, jcfg, {"tokens": ctx}, mode="train")
    top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)[:, -2:]
    for b in range(B):
      if ok[b] == n and top2[b, 1] - top2[b, 0] < 1e-4:
        ok[b] = t
    ctx = jnp.concatenate([ctx, jnp.asarray(want[:, t:t + 1])], axis=1)
  assert ok.sum() > 0
  for impl in ("pallas", "xla"):
    got = tserve.Engine(tcfg, model, max_len=32, impl=impl,
                        device="cpu").generate(prompts, 6)
    for b in range(B):
      np.testing.assert_array_equal(got[b, :ok[b]], want[b, :ok[b]])


@pytest.mark.parametrize("inputs", ["tokens", "embeds"])
def test_train_step_matches_reference(inputs):
  lr = 1e-3
  jcfg, tcfg, jparams, model = _models("f32", key=4)
  rng = np.random.default_rng(10)
  toks = rng.integers(0, jcfg.vocab, (4, S)).astype(np.int32)
  jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
  tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
  if inputs == "embeds":
    emb = rng.standard_normal((4, S, jcfg.d_model)).astype(np.float32)
    jb["src_embeds"] = jnp.asarray(emb)
    tb["src_embeds"] = torch.from_numpy(emb)
  joc = jopt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
  toc = topt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
  (jnew, _), jm = jax.jit(jmake_train_step(jcfg, joc))(
      (jparams, jopt.init_opt_state(jparams)), jb)
  (model, _), tm = tsteps.make_train_step(tcfg, toc)(
      (model, topt.init_opt_state(tzoo.param_tree(model))), tb)
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=1e-5)
  blocks = tzoo.param_tree(model)["blocks"]
  for name in ("q_norm_scale", "wq"):
    got = np.stack([b["attn"][name].detach().numpy() for b in blocks])
    np.testing.assert_allclose(got, np.asarray(jnew["blocks"]["attn"][name]),
                               atol=2 * lr)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_main_serves_on_the_cpu(impl, capsys):
  rc = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--gen", "6", "--device", "cpu",
                    "--impl", impl])
  assert rc == 0
  out = capsys.readouterr().out
  assert f"arch={ARCH}" in out and "generated (2, 6)" in out
