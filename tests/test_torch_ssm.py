"""The port's SSM slice against the reference, on the CPU: K4's plain
version, ``ssd_chunked`` on both arms, ``ssm_block``, the mamba2 smoke model
and the serving engine.

The same numpy inputs (and the reference's ``zoo.init`` weights, carried
over by ``convert.from_reference``) go through both packages.  The
reference's Pallas kernel runs in interpret mode, as its own tests run it.

Tolerances:
- K4 against the reference kernel and its einsum oracle: f32 1e-5, bf16
  5e-2 (tests/test_kernels_ssd.py; the inputs are rounded to bf16 in both
  packages and the math is f32, so only the summation order differs);
- ``ssd_chunked`` against the reference's: rtol/atol 2e-4 (the reference's
  own kernel-vs-model tolerance; the chunk-state einsums and the
  inter-chunk scan sum in another order);
- blocks and models: f32 rtol/atol 1e-4; bf16 2e-2, the reference's own
  bf16 tolerance (tests/test_models.py): projections and the causal conv
  round to bf16 along the way;
- greedy tokens: the reference's near-tie rule (tests/test_serve.py), as
  in tests/test_torch_serve.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ssd import ssd_intra_chunk as j_ssd  # noqa: E402
from repro.kernels.ssd import ssd_intra_chunk_ref as j_ssd_ref  # noqa: E402
from repro.launch.serve import Engine as JEngine  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.models.transformer import padded_vocab  # noqa: E402

ARCH = "mamba2-780m"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 20       # S > chunk 8 and not a multiple of it: a ragged tail
TIE_GAP = {"bf16": 2e-2, "f32": 1e-4}


def _tol(dtype):
  return dict(rtol=1e-4, atol=1e-4) if dtype == "f32" else dict(rtol=2e-2,
                                                                atol=2e-2)


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
      x, jax.Array) else x.float().numpy()


def _pair(a, dtype):
  jd, td = DTYPES[dtype]
  return jnp.asarray(a, jd), torch.from_numpy(np.array(a, np.float32)).to(td)


def _ssd_inputs(rng, bz, h, g, q, n, p):
  c = rng.standard_normal((bz, g, q, n)).astype(np.float32)
  b = rng.standard_normal((bz, g, q, n)).astype(np.float32)
  x = rng.standard_normal((bz, h, q, p)).astype(np.float32)
  dt = rng.uniform(0.01, 0.2, (bz, h, q)).astype(np.float32)
  # cum is a cumsum of negative decays, as ssd_chunked builds it
  cum = np.cumsum(-rng.uniform(0.001, 0.1, (bz, h, q)), axis=-1).astype(
      np.float32)
  return c, b, x, dt, cum


def _expand(c, h):
  """Groups → per-head copies, the reference kernel's layout."""
  return np.repeat(c, h // c.shape[1], axis=1)


# ---- K4's plain version ----------------------------------------------------

@pytest.mark.parametrize("shape", [
    # (BZ, H, Q, N, P): tests/test_kernels_ssd.py's shapes
    (2, 4, 32, 16, 8),
    (1, 2, 64, 32, 16),
    (3, 1, 16, 8, 8),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_plain_matches_reference_kernel(shape, dtype):
  bz, h, q, n, p = shape
  arrs = _ssd_inputs(np.random.default_rng(sum(shape)), bz, h, h, q, n, p)
  jargs, targs = zip(*(_pair(a, dtype) for a in arrs))
  got = tssd.ssd_intra_chunk(*targs)     # CPU tensors: the plain version
  assert got.dtype == torch.float32 and tuple(got.shape) == (bz, h, q, p)
  tol = 1e-5 if dtype == "f32" else 5e-2
  for want in (j_ssd(*jargs, interpret=True), j_ssd_ref(*jargs)):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", [
    # (BZ, H, G, Q, N, P)
    (2, 4, 2, 32, 16, 8),
    (1, 6, 1, 64, 16, 16),
    (2, 4, 1, 8, 16, 16),      # the smoke config's chunk, state and head dim
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_plain_groups_match_expanded_reference(shape, dtype):
  bz, h, g, q, n, p = shape
  c, b, x, dt, cum = _ssd_inputs(np.random.default_rng(q + h), bz, h, g, q,
                                 n, p)
  got = tssd.ssd_intra_chunk(*(_pair(a, dtype)[1] for a in (c, b, x, dt,
                                                            cum)))
  want = j_ssd(*(_pair(a, dtype)[0] for a in (_expand(c, h), _expand(b, h), x,
                                              dt, cum)), interpret=True)
  tol = 1e-5 if dtype == "f32" else 5e-2
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                             atol=tol)


def test_ssd_entry_takes_strided_views_and_out():
  """The model's layout: (z, q, head, ·) buffers read as (z, head, q, ·)
  views, the result written into a view of a (z, q, head, p) buffer."""
  rng = np.random.default_rng(4)
  bz, h, g, q, n, p = 3, 4, 2, 16, 8, 8
  c, b, x, dt, cum = (torch.from_numpy(a) for a in _ssd_inputs(
      rng, bz, h, g, q, n, p))
  want = tssd.ssd_intra_chunk_plain(c, b, x, dt, cum)
  views = [t.transpose(1, 2).contiguous().transpose(1, 2)
           for t in (c, b, x, dt, cum)]
  assert not views[2].is_contiguous()
  buf = torch.full((bz, q, h, p), float("nan"))
  before = tssd.ssd_intra_chunk.launches
  got = ops.ssd_intra_chunk(*views, out=buf.transpose(1, 2))
  assert tssd.ssd_intra_chunk.launches == before  # the CPU launches nothing
  assert got.data_ptr() == buf.data_ptr()
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  torch.testing.assert_close(buf, want.transpose(1, 2), rtol=0, atol=0)


def test_ssd_wrapper_refuses_what_it_does_not_take():
  z = torch.zeros
  with pytest.raises(ValueError, match="group"):
    tssd.ssd_intra_chunk(z(1, 3, 8, 4), z(1, 3, 8, 4), z(1, 4, 8, 8),
                         z(1, 4, 8), z(1, 4, 8))
  with pytest.raises(ValueError, match="shape mismatch"):
    tssd.ssd_intra_chunk(z(1, 1, 8, 4), z(1, 1, 8, 4), z(1, 4, 8, 8),
                         z(1, 4, 9), z(1, 4, 8))
  with pytest.raises(TypeError, match="one dtype"):
    tssd.ssd_intra_chunk(z(1, 1, 8, 4), z(1, 1, 8, 4), z(1, 4, 8, 8),
                         z(1, 4, 8, dtype=torch.float64), z(1, 4, 8))
  with pytest.raises(ValueError, match="out must be"):
    tssd.ssd_intra_chunk(z(1, 1, 8, 4), z(1, 1, 8, 4), z(1, 4, 8, 8),
                         z(1, 4, 8), z(1, 4, 8), out=z(1, 4, 8, 4))


# ---- ssd_chunked -------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (B, S, H, P, G, N, chunk, init_state)
    (2, 16, 4, 8, 1, 16, 8, False),    # S a multiple of the chunk
    (2, 12, 4, 8, 1, 16, 8, False),    # a ragged tail: dt = 0 padding
    (1, 24, 4, 16, 2, 8, 8, False),    # two groups
    (2, 20, 4, 8, 2, 16, 8, True),     # a non-zero initial state, ragged
    (2, 32, 4, 8, 1, 16, 32, False),   # one chunk: no inter-chunk term
], ids=str)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ssd_chunked_matches_reference(case, impl):
  b_, s, h, p, g, n, chunk, with_state = case
  rng = np.random.default_rng(s + g)
  xh = rng.standard_normal((b_, s, h, p)).astype(np.float32)
  dt = rng.uniform(0.01, 0.2, (b_, s, h)).astype(np.float32)
  a = -rng.uniform(0.1, 1.0, (h,)).astype(np.float32)
  bm = rng.standard_normal((b_, s, g, n)).astype(np.float32)
  cm = rng.standard_normal((b_, s, g, n)).astype(np.float32)
  s0 = (rng.standard_normal((b_, h, n, p)).astype(np.float32)
        if with_state else None)
  wy, wf = jssm.ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)), chunk,
                            None if s0 is None else jnp.asarray(s0))
  gy, gf = tssm.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)), chunk,
                            None if s0 is None else torch.from_numpy(s0),
                            impl=impl)
  assert gy.dtype == gf.dtype == torch.float32
  assert gy.shape == wy.shape and gf.shape == wf.shape
  np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=2e-4, atol=2e-4)
  np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=2e-4, atol=2e-4)


def test_ssd_chunked_refuses_an_unknown_impl():
  x = torch.zeros(1, 8, 2, 8)
  with pytest.raises(ValueError, match="impl"):
    tssm.ssd_chunked(x, torch.zeros(1, 8, 2), -torch.ones(2),
                     torch.zeros(1, 8, 1, 4), torch.zeros(1, 8, 1, 4), 8,
                     impl="auto")


# ---- ssm_block and the model -----------------------------------------------

def _cfgs(dtype):
  jd, td = DTYPES[dtype]
  return (jconfigs.get_config(ARCH, smoke=True).replace(dtype=jd),
          tconfigs.get_config(ARCH, smoke=True).replace(dtype=td))


def _tree(dtype, key=0, head_scale=1):
  jcfg, tcfg = _cfgs(dtype)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  jparams["lm_head"] = jparams["lm_head"] * head_scale
  return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ssm_block_prefill_then_decode(dtype, impl):
  jcfg, tcfg, _, tree = _tree(dtype, key=1)
  lp = jax.tree.map(lambda t: t[1], tree["blocks"]["ssm"])
  jp = jax.tree.map(jnp.asarray, lp)
  tp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
  rng = np.random.default_rng(6)
  x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
  jx, tx = _pair(x, dtype)
  want, wst = jssm.ssm_block(jp, jcfg, jx, mode="prefill")
  got, gst = tssm.ssm_block(tp, tcfg, tx, mode="prefill", impl=impl)
  assert got.dtype == tcfg.dtype and got.shape == want.shape
  np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
  for name in ("ssm", "conv", "bc_conv"):
    assert gst[name].shape == wst[name].shape
    assert _np(gst[name]).dtype == np.float32
    assert gst[name].dtype == (torch.float32 if name == "ssm" else tcfg.dtype)
    np.testing.assert_allclose(_np(gst[name]), _np(wst[name]), **_tol(dtype))
  # two decode steps from the same (reference) state in both packages
  wst_t = {k: torch.from_numpy(np.array(_np(v))).to(gst[k].dtype)
           for k, v in wst.items()}
  for t in range(2):
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jx1, tx1 = _pair(x1, dtype)
    want, wst = jssm.ssm_block(jp, jcfg, jx1, mode="decode", state=wst)
    got, gst = tssm.ssm_block(tp, tcfg, tx1, mode="decode", state=wst_t)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype),
                               err_msg=f"decode step {t}")
    for name in ("ssm", "conv", "bc_conv"):
      np.testing.assert_allclose(_np(gst[name]), _np(wst[name]),
                                 **_tol(dtype))
    wst_t = {k: torch.from_numpy(np.array(_np(v))).to(gst[k].dtype)
             for k, v in wst.items()}


def test_causal_conv_sums_in_the_input_dtype():
  """bf16 products summed left to right in bf16, as the reference sums
  them: the same bits, not an f32 accumulation rounded once."""
  rng = np.random.default_rng(8)
  x = rng.standard_normal((2, 9, 12)).astype(np.float32)
  w = rng.standard_normal((4, 12)).astype(np.float32)
  st = rng.standard_normal((2, 3, 12)).astype(np.float32)
  for state in (None, st):
    wy, ws = jssm._causal_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
        None if state is None else jnp.asarray(state, jnp.bfloat16))
    gy, gs = tssm._causal_conv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        None if state is None else torch.from_numpy(state).bfloat16())
    assert gy.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(gy), _np(wy))
    np.testing.assert_array_equal(_np(gs), _np(ws))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_prefill_and_decode_match_reference(dtype):
  jcfg, tcfg, jparams, tree = _tree(dtype)
  model = convert.from_reference(tree, tcfg, device="cpu")
  rng = np.random.default_rng(9)
  toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
  steps = rng.integers(0, jcfg.vocab, (B, 3)).astype(np.int32)
  wl, wc, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                           mode="prefill")
  for impl in ("pallas", "xla"):
    gl, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(toks)},
                             mode="prefill", impl=impl)
    assert gl.shape == (B, 1, padded_vocab(tcfg)) == wl.shape
    assert gl.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))
    assert int(gc["len"]) == int(wc["len"]) == S
    for name in ("ssm", "conv", "bc_conv"):
      assert gc["ssm"][name].shape == wc["ssm"][name].shape
      np.testing.assert_allclose(_np(gc["ssm"][name]), _np(wc["ssm"][name]),
                                 **_tol(dtype))
    # decode steps, the cache updated in place
    wcache = wc
    for t in range(steps.shape[1]):
      tok = steps[:, t:t + 1]
      wl1, wcache, _ = jzoo.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(tok)},
                                    mode="decode", cache=wcache)
      ssm_before = gc["ssm"]["ssm"]
      gl1, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(tok)},
                                mode="decode", cache=gc)
      assert gc["ssm"]["ssm"] is ssm_before
      np.testing.assert_allclose(_np(gl1), _np(wl1), **_tol(dtype),
                                 err_msg=f"{impl} decode step {t}")
      assert int(gc["len"]) == int(wcache["len"]) == S + t + 1
      for name in ("ssm", "conv", "bc_conv"):
        np.testing.assert_allclose(_np(gc["ssm"][name]),
                                   _np(wcache["ssm"][name]), **_tol(dtype))
  # train mode: every position, forward only
  wl, _, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          mode="train")
  gl, gcache, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(toks)},
                               mode="train", impl="pallas")
  assert gcache is None and gl.shape == wl.shape
  np.testing.assert_allclose(_np(gl), _np(wl), **_tol(dtype))


def test_convert_and_init_cache_follow_the_reference_layout():
  jcfg, tcfg, jparams, tree = _tree("f32", key=5)
  model = convert.from_reference(tree, tcfg, device="cpu")
  assert isinstance(model, tzoo.SSMLM)
  assert tzoo.param_count(model) == jzoo.param_count(jparams)
  for i, layer in enumerate(model.blocks):
    for name, t in layer.ssm.named_parameters():
      np.testing.assert_array_equal(t.numpy(),
                                    tree["blocks"]["ssm"][name][i])
    np.testing.assert_array_equal(layer.ln_norm_scale.numpy(),
                                  tree["blocks"]["ln_norm_scale"][i])
  np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
  assert not any(p.requires_grad for p in model.parameters())
  with pytest.raises(ValueError, match="layers"):
    convert.from_reference(tree, tcfg.replace(n_layers=3), device="cpu")
  got = tzoo.init_cache(tcfg, 3, 40, device="cpu")
  want = jzoo.init_cache(jcfg, 3, 40)
  assert int(got["len"]) == int(want["len"]) == 0
  for name in ("ssm", "conv", "bc_conv"):
    assert got["ssm"][name].shape == want["ssm"][name].shape
    assert not got["ssm"][name].any()
  assert got["ssm"]["ssm"].dtype == torch.float32
  assert got["ssm"]["conv"].dtype == tcfg.dtype


def test_init_draws_from_the_generator():
  cfg = tconfigs.get_config(ARCH, smoke=True)
  a = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
  b = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
  c = tzoo.init(cfg, torch.Generator().manual_seed(4), device="cpu")
  jcfg = jconfigs.get_config(ARCH, smoke=True)
  assert tzoo.param_count(a) == jzoo.param_count(
      jzoo.init(jcfg, jax.random.PRNGKey(0)))
  for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
    assert torch.equal(pa, pb) and pa.shape == pc.shape
  assert not torch.equal(a.embed, c.embed)


# ---- the serving engine ------------------------------------------------------

def _comparable_steps(jparams, jcfg, prompts, toks, gap):
  """Per row: the steps before the first near-tie of the reference's own
  logits along its own tokens."""
  n = toks.shape[1]
  ok = np.full(prompts.shape[0], n)
  ctx = jnp.asarray(prompts, jnp.int32)
  for t in range(n):
    logits, _, _ = jzoo.forward(jparams, jcfg, {"tokens": ctx}, mode="train")
    lg = np.asarray(logits[:, -1], np.float32)
    top2 = np.sort(lg, axis=-1)[:, -2:]
    for b in range(prompts.shape[0]):
      if ok[b] == n and top2[b, 1] - top2[b, 0] < gap:
        ok[b] = t
    ctx = jnp.concatenate([ctx, jnp.asarray(toks[:, t:t + 1], jnp.int32)],
                          axis=1)
  return ok


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_matches_reference_engine(dtype):
  jcfg, tcfg, jparams, tree = _tree(dtype, key=2, head_scale=8)
  model = convert.from_reference(tree, tcfg, device="cpu")
  prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (B, 12),
                                              dtype=np.int32)
  n_new = 6
  want = JEngine(jcfg, jparams, max_len=48).generate(prompts, n_new)
  ok = _comparable_steps(jparams, jcfg, prompts, want, TIE_GAP[dtype])
  assert ok.sum() > 0
  for impl in ("pallas", "xla"):
    # the SSM state has no length: a max_len below the prompt's is no limit
    eng = tserve.Engine(tcfg, model, max_len=8, impl=impl, device="cpu")
    got = eng.generate(prompts, n_new)
    assert got.shape == (B, n_new) and got.dtype == np.int32
    for b in range(B):
      np.testing.assert_array_equal(got[b, :ok[b]], want[b, :ok[b]],
                                    err_msg=f"{impl} row {b}")
