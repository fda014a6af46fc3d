"""The port's enc-dec LM (seamless-m4t) against the reference, on the CPU.

The same weights (the reference's ``zoo.init`` tree, carried over by
``convert.from_reference``) and the same numpy tokens and source frames go
through both packages at seamless-m4t-large-v2's ``smoke_config()``: 2
encoder and 2 decoder layers, d 64, 4 heads of 16, a 24-frame source.  The
reference's Pallas arm runs in interpret mode, as its own tests run it on
the CPU.

Tolerances: f32 rtol/atol 1e-4 and bf16 2e-2, those of the dense model
tests (tests/test_torch_models.py; the reference's own bf16 tolerance for
its prefill/decode consistency test, tests/test_models.py).  Greedy tokens
follow the reference's near-tie rule (tests/test_serve.py), with the LM
head scaled 8× in both packages as tests/test_torch_serve.py does.  One
f32 train step: loss and grad norm rtol 1e-5 (tests/test_torch_train.py).

Two declared differences are pinned: the port's ``encode`` takes
``impl`` (the serving engine passes its own, so on 'pallas' the encoder
launches K3; the reference's always takes the chunked arm), and its engine
encodes once per ``generate`` where the reference's encodes twice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import Engine as JEngine  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_takes  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "seamless-m4t-large-v2"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 12
TIE_GAP = {"bf16": 2e-2, "f32": 1e-4}


def _tol(dtype):
  return (dict(rtol=1e-4, atol=1e-4) if dtype == "f32"
          else dict(rtol=2e-2, atol=2e-2))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
      x, jax.Array) else x.detach().float().numpy()


def _models(dtype, key=0, head_scale=1):
  jd, td = DTYPES[dtype]
  jcfg = jconfigs.get_config(ARCH, smoke=True).replace(dtype=jd)
  tcfg = tconfigs.get_config(ARCH, smoke=True).replace(dtype=td)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  jparams["lm_head"] = jparams["lm_head"] * head_scale
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  return jcfg, tcfg, jparams, model


def _inputs(cfg, s=S, seed=4):
  rng = np.random.default_rng(seed)
  toks = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
  src = rng.standard_normal((B, cfg.src_len, cfg.d_model)).astype(np.float32)
  return toks, src


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
  jcfg, tcfg, jparams, model = _models(dtype)
  _, src = _inputs(jcfg)
  want = jencdec.encode(jparams, jcfg, jnp.asarray(src))
  with torch.inference_mode():
    got = tencdec.encode(model, tcfg, torch.from_numpy(src))
  assert got.shape == want.shape and got.dtype == tcfg.dtype
  np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_on_pallas_matches_the_chunked_arm(dtype):
  """Declared difference: ``encode(impl="pallas")`` runs the encoder's
  non-causal self-attention through K3 (its plain version here); it holds
  the chunked arm, which is the reference's, to the model tolerances."""
  jcfg, tcfg, jparams, model = _models(dtype, key=1)
  _, src = _inputs(jcfg, seed=5)
  with torch.inference_mode():
    got = tencdec.encode(model, tcfg, torch.from_numpy(src), impl="pallas")
    xla = tencdec.encode(model, tcfg, torch.from_numpy(src))
  want = jencdec.encode(jparams, jcfg, jnp.asarray(src))
  np.testing.assert_allclose(_np(got), _np(xla), **_tol(dtype))
  np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_train_and_prefill_logits_and_cache(impl, dtype):
  jcfg, tcfg, jparams, model = _models(dtype)
  toks, src = _inputs(jcfg)
  jb = {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src)}
  tb = {"tokens": torch.from_numpy(toks), "src_embeds": torch.from_numpy(src)}
  for mode in ("train", "prefill"):
    wl, wc, _ = jzoo.forward(jparams, jcfg, jb, mode=mode, impl=impl)
    with torch.inference_mode():
      gl, gc, ga = tzoo.forward(model, tcfg, tb, mode=mode, impl=impl)
    assert gl.shape == wl.shape and gl.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
    assert float(ga) == 0.0
    if mode == "train":
      assert gc is None and wc is None
      continue
    assert gc["k"].shape == (jcfg.dec_layers, B, S, tcfg.n_kv_heads, tcfg.hd)
    assert int(gc["len"]) == int(wc["len"]) == S
    for name in ("k", "v"):
      np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **_tol(dtype))


def _cross_case(dtype, seed):
  """The second decoder layer's cross-attention weights, and encoder-side
  k and v drawn from ``seed``."""
  jd, td = DTYPES[dtype]
  jcfg = jconfigs.get_config(ARCH, smoke=True).replace(dtype=jd)
  tcfg = tconfigs.get_config(ARCH, smoke=True).replace(dtype=td)
  tree = jax.tree.map(np.asarray, jzoo.init(jcfg, jax.random.PRNGKey(3)))
  p = jax.tree.map(lambda a: a[1], tree["dec"]["cross"])
  rng = np.random.default_rng(seed)
  kv_shape = (B, jcfg.src_len, jcfg.n_kv_heads, jcfg.hd)
  k, v = (rng.standard_normal(kv_shape).astype(np.float32) for _ in range(2))
  return jcfg, tcfg, p, k, v, rng


def _pair(a, dtype):
  jd, td = DTYPES[dtype]
  return jnp.asarray(a, jd), torch.from_numpy(np.array(a, np.float32)).to(td)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attention_kv_override(mode, dtype):
  """Cross-attention: k and v given (the encoder's), non-causal, q with
  RoPE at the decoder positions; in decode the layer cache comes back
  untouched."""
  jcfg, tcfg, p, k, v, rng = _cross_case(dtype, seed=7)
  s = 1 if mode == "decode" else S
  x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
  base = 5 if mode == "decode" else 0
  pos = np.tile(np.arange(base, base + s, dtype=np.int32), (B, 1))
  (jx, tx), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (x, k, v))
  jp = jax.tree.map(jnp.asarray, p)
  tp = {name: torch.from_numpy(np.array(a)) for name, a in p.items()}
  impls = ("xla",) if mode == "decode" else ("pallas", "xla")
  cache = None
  if mode == "decode":
    cache = rng.standard_normal((B, 16, jcfg.n_kv_heads, jcfg.hd)).astype(
        np.float32)
  for impl in impls:
    jc = None if cache is None else {"k": _pair(cache, dtype)[0],
                                     "v": _pair(cache, dtype)[0]}
    tc = None if cache is None else {"k": _pair(cache, dtype)[1],
                                     "v": _pair(cache, dtype)[1]}
    clen = 5 if mode == "decode" else None
    want, wkv = jattn.attention(
        jp, jcfg, jx, jnp.asarray(pos), mode=mode, impl=impl,
        layer_cache=jc, cache_len=None if clen is None else jnp.asarray(clen),
        kv_override=(jk, jv))
    got, gkv = tattn.attention(
        tp, tcfg, tx, torch.from_numpy(pos), mode=mode, impl=impl,
        layer_cache=tc, cache_len=None if clen is None else torch.tensor(
            clen, dtype=torch.int32), kv_override=(tk, tv))
    assert got.shape == want.shape and got.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if mode == "decode":
      assert gkv is tc                      # the cache, untouched
      np.testing.assert_array_equal(_np(tc["k"]), _np(_pair(cache,
                                                            dtype)[1]))
    elif mode == "prefill":
      assert gkv["k"] is tk and gkv["v"] is tv
      np.testing.assert_allclose(_np(gkv["k"]), _np(wkv["k"]), **_tol(dtype))
    else:
      assert gkv is None and wkv is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_non_causal_self_attention(dtype):
  """``causal=False`` (the encoder's self-attention): every key visible, on
  both arms, against the reference."""
  jcfg, tcfg, p, _, _, rng = _cross_case(dtype, seed=8)
  x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
  pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
  jx, tx = _pair(x, dtype)
  tp = {name: torch.from_numpy(np.array(a)) for name, a in p.items()}
  for impl in ("pallas", "xla"):
    want, _ = jattn.attention(jax.tree.map(jnp.asarray, p), jcfg, jx,
                              jnp.asarray(pos), impl=impl, causal=False)
    got, _ = tattn.attention(tp, tcfg, tx, torch.from_numpy(pos), impl=impl,
                             causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
  causal, _ = tattn.attention(tp, tcfg, tx, torch.from_numpy(pos))
  assert not np.allclose(_np(causal)[:, 0], _np(got)[:, 0])


def test_cross_kv_slices_are_views_k3_reads():
  """Each decoder layer's cross K/V is a strided view of one product, in
  a layout the bf16 kernel takes as it is (no copy on the card)."""
  _, tcfg, _, model = _models("bf16")
  _, src = _inputs(tcfg)
  with torch.inference_mode():
    enc_out = tencdec.encode(model, tcfg, torch.from_numpy(src))
    ck, cv = tencdec.cross_kv(model, tcfg, enc_out)
  shape = (tcfg.dec_layers, B, tcfg.src_len, tcfg.n_kv_heads, tcfg.hd)
  assert ck.shape == cv.shape == shape
  assert (ck.untyped_storage().data_ptr()
          == cv.untyped_storage().data_ptr())      # one buffer
  for i in range(tcfg.dec_layers):
    for t in (ck[i], cv[i]):
      assert not t.is_contiguous() and kernel_takes(t.transpose(1, 2))
    want = torch.matmul(enc_out, model.dec[i].cross.wk.to(tcfg.dtype).flatten(
        1)).unflatten(-1, (tcfg.n_kv_heads, tcfg.hd))
    torch.testing.assert_close(ck[i], want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
  """Prefill, the cache seated at max_len, then three decode steps with
  the encoder output given: logits and the cache against the
  reference's."""
  jcfg, tcfg, jparams, model = _models(dtype, key=2)
  s, max_len, steps = 8, 16, 3
  toks, src = _inputs(jcfg, s + steps, seed=6)
  jenc = jencdec.encode(jparams, jcfg, jnp.asarray(src))
  _, wc, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :s]),
                                          "src_embeds": jnp.asarray(src)},
                          mode="prefill")
  full = jzoo.init_cache(jcfg, B, max_len)
  wc = jax.tree.map(lambda f, g: g.astype(f.dtype) if f.shape == g.shape
                    else jnp.pad(g, [(0, a - b) for a, b in zip(
                        f.shape, g.shape)]).astype(f.dtype), full, wc)
  with torch.inference_mode():
    tenc = tencdec.encode(model, tcfg, torch.from_numpy(src))
    _, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
        toks[:, :s]), "enc_out": tenc}, mode="prefill")
    gc = tserve.seat_cache(tcfg, gc, max_len, "cpu")
    assert gc["k"].shape == (tcfg.dec_layers, B, max_len, tcfg.n_kv_heads,
                             tcfg.hd)
    kbuf = gc["k"]
    for t in range(s, s + steps):
      wl, wc, _ = jzoo.forward(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               mode="decode", cache=wc, enc_out=jenc)
      gl, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
          toks[:, t:t + 1]), "enc_out": tenc}, mode="decode", cache=gc)
      np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
      for name in ("k", "v"):
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]),
                                   **_tol(dtype))
  assert gc["k"] is kbuf                    # written in place
  assert int(gc["len"]) == s + steps


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_decode_consistency(dtype):
  """The port's version of tests/test_models.py's check: decode(prefill(
  x[:t]), x[t]) logits equal the train-forward logits at t (2e-2, the
  reference's tolerance there)."""
  _, tcfg, _, model = _models(dtype, key=4)
  toks, src = _inputs(tcfg, 16, seed=9)
  tt, ts = torch.from_numpy(toks), torch.from_numpy(src)
  with torch.inference_mode():
    full, _, _ = tzoo.forward(model, tcfg, {"tokens": tt, "src_embeds": ts},
                              mode="train")
    _, cache, _ = tzoo.forward(model, tcfg, {"tokens": tt[:, :14],
                                             "src_embeds": ts},
                               mode="prefill")
    cache = tserve.seat_cache(tcfg, cache, 18, "cpu")
    enc_out = tencdec.encode(model, tcfg, ts)
    for t in (14, 15):
      logits, cache, _ = tzoo.forward(model, tcfg, {"tokens": tt[:, t:t + 1]},
                                      mode="decode", cache=cache,
                                      enc_out=enc_out)
      np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                 atol=2e-2, rtol=2e-2)


def _comparable_steps(jparams, jcfg, prompts, src, toks, gap):
  """Per row: the steps before the first near-tie of the reference's own
  logits along its own tokens."""
  n = toks.shape[1]
  ok = np.full(B, n)
  ctx = jnp.asarray(prompts, jnp.int32)
  for t in range(n):
    logits, _, _ = jzoo.forward(jparams, jcfg, {"tokens": ctx, "src_embeds":
                                                jnp.asarray(src)},
                                mode="train")
    lg = np.asarray(logits[:, -1], np.float32)
    top2 = np.sort(lg, axis=-1)[:, -2:]
    for b in range(B):
      if ok[b] == n and top2[b, 1] - top2[b, 0] < gap:
        ok[b] = t
    ctx = jnp.concatenate([ctx, jnp.asarray(toks[:, t:t + 1], jnp.int32)],
                          axis=1)
  return ok


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_engine_matches_reference_engine(dtype):
  jcfg, tcfg, jparams, model = _models(dtype, key=2, head_scale=8)
  prompts, src = _inputs(jcfg, seed=5)
  want = JEngine(jcfg, jparams, max_len=32).generate(prompts, 6,
                                                     src_embeds=src)
  ok = _comparable_steps(jparams, jcfg, prompts, src, want, TIE_GAP[dtype])
  assert ok.sum() > 0
  for impl in ("pallas", "xla"):
    eng = tserve.Engine(tcfg, model, max_len=32, impl=impl, device="cpu")
    got = eng.generate(prompts, 6, src_embeds=src)
    assert got.shape == (B, 6) and got.dtype == np.int32
    for b in range(B):
      np.testing.assert_array_equal(got[b, :ok[b]], want[b, :ok[b]],
                                    err_msg=f"{impl} row {b}")


def test_generate_encodes_once(monkeypatch):
  """Declared difference: the engine encodes once per ``generate``, on its
  own ``impl``, and hands that output to the prefill and every decode
  step (the reference's encodes again inside its prefill)."""
  _, tcfg, _, model = _models("f32", key=6)
  prompts, src = _inputs(tcfg, seed=10)
  calls, seen = [], []
  encode = tencdec.encode

  def counting(*args, **kw):
    calls.append(kw.get("impl"))
    out = encode(*args, **kw)
    seen.append(out)
    return out
  monkeypatch.setattr(tencdec, "encode", counting)
  eng = tserve.Engine(tcfg, model, max_len=32, impl="pallas", device="cpu")
  decode = eng._decode
  enc_outs = []

  def spy(model, cache, batch):
    enc_outs.append(batch["enc_out"])
    return decode(model, cache, batch)
  eng._decode = spy
  eng.generate(prompts, 4, src_embeds=src)
  assert calls == ["pallas"]
  assert len(enc_outs) == 3 and all(e is seen[0] for e in enc_outs)
  with pytest.raises(ValueError, match="src_embeds"):
    eng.generate(prompts, 2)


def test_train_step_matches_reference():
  """One f32 step with the source frames in the batch: loss and grad norm
  within 1e-5 of the reference's, updated parameters within 2·lr."""
  lr = 1e-3
  jcfg, tcfg, jparams, model = _models("f32", key=7)
  toks, src = _inputs(jcfg, 16, seed=11)
  jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
        "src_embeds": jnp.asarray(src)}
  tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
        "src_embeds": torch.from_numpy(src)}
  joc = jopt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
  toc = topt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
  (jnew, _), jm = jax.jit(jmake_train_step(jcfg, joc))(
      (jparams, jopt.init_opt_state(jparams)), jb)
  step = tsteps.make_train_step(tcfg, toc)
  (model, tstate), tm = step((model, topt.init_opt_state(
      tzoo.param_tree(model))), tb)
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=1e-5)
  tree = tzoo.param_tree(model)
  for path in (("enc", "attn", "wq"), ("dec", "cross", "wk"),
               ("dec", "mlp", "w2")):
    want = np.asarray(jnew[path[0]][path[1]][path[2]], np.float32)
    got = np.stack([layer[path[1]][path[2]].detach().numpy()
                    for layer in tree[path[0]]])
    np.testing.assert_allclose(got, want, atol=2 * lr)
  np.testing.assert_allclose(tree["enc_norm_scale"].detach().numpy(),
                             np.asarray(jnew["enc_norm_scale"]), atol=2 * lr)
  assert int(tstate["step"]) == 1


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none(remat):
  """remat='full' recomputes each layer in the backward; 'dots' keeps
  every activation, as the reference's enc-dec does: the same logits and
  gradients as 'none'."""
  _, tcfg, _, model = _models("f32", key=8)
  toks, src = _inputs(tcfg, seed=12)
  batch = {"tokens": torch.from_numpy(toks),
           "src_embeds": torch.from_numpy(src)}
  params = list(model.parameters())
  out = {}
  for r in ("none", remat):
    for p in params:
      p.requires_grad_(True)
      p.grad = None
    logits, _, _ = tzoo.forward(model, tcfg, batch, mode="train", remat=r)
    logits.float().square().mean().backward()
    out[r] = (logits.detach(), [p.grad.clone() for p in params])
  assert torch.equal(out[remat][0], out["none"][0])
  for a, b in zip(out[remat][1], out["none"][1]):
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
  with pytest.raises(ValueError, match="remat"):
    tzoo.forward(model, tcfg, batch, mode="train", remat="all")


def test_convert_and_param_tree_keep_the_reference_layout():
  jcfg, tcfg, jparams, model = _models("f32", key=5)
  tree = jax.tree.map(np.asarray, jparams)
  assert tzoo.param_count(model) == jzoo.param_count(jparams)
  ptree = tzoo.param_tree(model)
  assert sorted(ptree) == sorted(tree)
  assert len(ptree["enc"]) == jcfg.enc_layers
  assert len(ptree["dec"]) == jcfg.dec_layers
  assert sorted(ptree["dec"][0]) == sorted(tree["dec"])
  assert "w3" not in ptree["enc"][0]["mlp"]          # ungated GELU
  for i, layer in enumerate(ptree["dec"]):
    np.testing.assert_array_equal(layer["cross"]["wv"].numpy(),
                                  tree["dec"]["cross"]["wv"][i])
  with pytest.raises(ValueError, match="layers"):
    convert.from_reference(tree, tcfg.replace(dec_layers=3), device="cpu")


def test_published_config_and_init():
  full = tconfigs.get_config(ARCH)
  assert (full.enc_layers, full.dec_layers, full.d_model, full.n_heads,
          full.hd, full.d_ff, full.src_len) == (24, 24, 1024, 16, 64, 8192,
                                                4096)
  cfg = tconfigs.get_config(ARCH, smoke=True)
  a = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
  b = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
  for pa, pb in zip(a.parameters(), b.parameters()):
    assert torch.equal(pa, pb)
  jcfg = jconfigs.get_config(ARCH, smoke=True)
  assert tzoo.param_count(a) == jzoo.param_count(
      jzoo.init(jcfg, jax.random.PRNGKey(0)))
  cache = tzoo.init_cache(cfg, 2, 40, device="cpu")
  assert cache["k"].shape == (cfg.dec_layers, 2, 40, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_main_serves_on_the_cpu(impl, capsys):
  rc = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--gen", "6", "--device", "cpu",
                    "--impl", impl])
  assert rc == 0
  out = capsys.readouterr().out
  assert f"arch={ARCH}" in out and "generated (2, 6)" in out
