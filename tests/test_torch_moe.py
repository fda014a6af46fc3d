"""The port's mixture-of-experts layer and MoE models against the reference,
on the CPU.

The same weights (the reference's ``moe_params`` and ``zoo.init`` trees,
carried over as numpy arrays or by ``convert.from_reference``) and the same
numpy inputs go through both packages, at the ``smoke_config()`` of
mixtral-8x7b (4 experts, top-2, window 16) and phi3.5-moe (4 experts,
top-2).  The reference's Pallas arm runs in interpret mode, as its own
tests run it on the CPU.

Tolerances: in f32 the routes (expert ids), the dispatch slots and the keep
mask are equal exactly (both routers compute the same f32 logits up to the
order of a 64-term sum, far from any tie these inputs have); y and the
logits within rtol/atol 1e-4 (the f32 tolerance of the dense tests); the
aux loss within 1e-6.  In bf16 the router still runs in f32 on the same
bf16 input, so routes agree except where two probabilities tie to within
``ROUTE_MARGIN``; y is held to the dense tests' bf16 tolerance 2e-2 on the
tokens whose routes and keep mask agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 24   # S > 16: mixtral's smoke window masks inside the prefill
# f32 router logits of the two packages differ by the order of their sums;
# a route may differ only between probabilities closer than this
ROUTE_MARGIN = 1e-5


def _cfgs(arch, dtype="f32", **kw):
  jd, td = DTYPES[dtype]
  return (jconfigs.get_config(arch, smoke=True).replace(dtype=jd, **kw),
          tconfigs.get_config(arch, smoke=True).replace(dtype=td, **kw))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
      x, jax.Array) else x.float().numpy()


def _layer_params(jcfg, key=1, router_scale=1.0):
  p = jax.tree.map(np.asarray, jmoe.moe_params(jax.random.PRNGKey(key),
                                                jcfg))
  p["router"] = p["router"] * router_scale
  return p


def _torch_tree(p):
  return {k: (_torch_tree(v) if isinstance(v, dict)
              else torch.from_numpy(np.array(v))) for k, v in p.items()}


def _x(jcfg, dtype, seed=3, s=S):
  x = np.random.default_rng(seed).standard_normal(
      (B, s, jcfg.d_model)).astype(np.float32)
  jd, td = DTYPES[dtype]
  return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _reference_dispatch(p, jcfg, jx):
  """The reference's routes, slots, keep mask, buffer, y and aux."""
  cap = jmoe.capacity(jcfg, jx.shape[1])
  gate, idx, aux = jmoe._route(jnp.asarray(p["router"]), jcfg, jx)
  buf, se, sp, keep = jax.vmap(lambda xr, ir, gr: jmoe._dispatch_row(
      xr, ir, gr, jcfg.n_experts, cap))(jx, idx, gate)
  y, aux2 = jmoe.moe_block(jax.tree.map(jnp.asarray, p), jcfg, jx)
  assert float(aux2) == float(aux)
  return dict(gate=gate, idx=idx, aux=aux, buf=buf, slot_e=se, slot_p=sp,
              keep=keep, y=y)


def _port_dispatch(p, tcfg, tx):
  cap = tmoe.capacity(tcfg, tx.shape[1])
  gate, idx, aux = tmoe._route(torch.from_numpy(p["router"]), tcfg, tx)
  buf, se, sp, keep = tmoe._dispatch(tx, idx, tcfg.n_experts, cap)
  y, aux2 = tmoe.moe_block(_torch_tree(p), tcfg, tx)
  assert float(aux2) == float(aux)
  return dict(gate=gate, idx=idx, aux=aux, buf=buf.permute(1, 0, 2, 3),
              slot_e=se, slot_p=sp, keep=keep, y=y)


@pytest.mark.parametrize("arch,seq,want", [
    ("mixtral-8x7b", 2048, 640), ("mixtral-8x7b", 1, 8),
    ("mixtral-8x7b", 4096, 1280), ("phi3.5-moe-42b-a6.6b", 2048, 320),
    ("phi3.5-moe-42b-a6.6b", 1, 8)])
def test_capacity_matches_the_reference(arch, seq, want):
  """C = max(8, ⌈topk·S·cf/E⌉ rounded up to 8), at the published configs
  and the smoke ones."""
  got = tmoe.capacity(tconfigs.get_config(arch), seq)
  assert got == jmoe.capacity(jconfigs.get_config(arch), seq) == want
  jcfg, tcfg = _cfgs(arch)
  assert tmoe.capacity(tcfg, seq) == jmoe.capacity(jcfg, seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_routes_slots_and_output_f32(arch):
  jcfg, tcfg = _cfgs(arch)
  p = _layer_params(jcfg)
  jx, tx = _x(jcfg, "f32")
  want, got = _reference_dispatch(p, jcfg, jx), _port_dispatch(p, tcfg, tx)
  for name in ("idx", "slot_e", "slot_p", "keep"):
    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                  err_msg=name)
  np.testing.assert_allclose(_np(got["gate"]), _np(want["gate"]), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(_np(got["buf"]), _np(want["buf"]), rtol=0,
                             atol=0)
  np.testing.assert_allclose(_np(got["y"]), _np(want["y"]), rtol=1e-4,
                             atol=1e-4)
  np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                             atol=1e-6)
  assert got["y"].dtype == tcfg.dtype and got["idx"].dtype == torch.int64


@pytest.mark.parametrize("arch", ARCHS)
def test_a_router_tie_goes_to_the_lower_expert(arch):
  """A zero router gives every expert the probability 1/E: both packages
  route every token to experts [0, 1] (jax.lax.top_k's order), the aux is
  E · (1 at expert 0) · (1/E) = 1, and the capacity drops the same pairs."""
  jcfg, tcfg = _cfgs(arch)
  p = _layer_params(jcfg, router_scale=0.0)
  jx, tx = _x(jcfg, "f32")
  want, got = _reference_dispatch(p, jcfg, jx), _port_dispatch(p, tcfg, tx)
  assert (np.asarray(want["idx"]) == [0, 1]).all()
  np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
  np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
  # torch.topk alone would route the tie elsewhere on the CPU
  probs = torch.full((1, tcfg.n_experts), 1.0 / tcfg.n_experts)
  assert torch.topk(probs, 2).indices.tolist() != [[0, 1]]
  assert float(got["aux"]) == pytest.approx(1.0, abs=1e-6)
  np.testing.assert_allclose(_np(got["y"]), _np(want["y"]), rtol=1e-4,
                             atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_the_same_pairs(arch):
  """capacity_factor 0.25: C = 8 for S 24 against 12 pairs per expert on
  average, so most queues overflow; the same pairs drop in both packages,
  each dropped pair adding a zero to its expert's slot 0."""
  jcfg, tcfg = _cfgs(arch, capacity_factor=0.25)
  p = _layer_params(jcfg, router_scale=4.0)
  jx, tx = _x(jcfg, "f32", seed=4)
  want, got = _reference_dispatch(p, jcfg, jx), _port_dispatch(p, tcfg, tx)
  keep = np.asarray(want["keep"])
  assert (~keep).sum() > 0
  for name in ("idx", "slot_e", "slot_p", "keep"):
    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                  err_msg=name)
  np.testing.assert_array_equal(_np(got["buf"]), _np(want["buf"]))
  np.testing.assert_allclose(_np(got["y"]), _np(want["y"]), rtol=1e-4,
                             atol=1e-4)
  # a token whose every choice dropped gets no expert output
  gone = ~keep.any(axis=-1)
  if gone.any():
    assert not _np(got["y"])[gone].any()


def _top_margin(probs, k):
  """Per token, the smallest gap between neighbouring probabilities in the
  sorted order around the top k."""
  srt = np.sort(probs, axis=-1)[..., ::-1]
  return np.min(srt[..., :k] - srt[..., 1:k + 1], axis=-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16(arch):
  jcfg, tcfg = _cfgs(arch, "bf16")
  p = _layer_params(jcfg)
  jx, tx = _x(jcfg, "bf16")
  want, got = _reference_dispatch(p, jcfg, jx), _port_dispatch(p, tcfg, tx)
  wi, gi = np.asarray(want["idx"]), got["idx"].numpy()
  logits = np.asarray(jx, np.float32) @ p["router"]
  probs = np.exp(logits - logits.max(-1, keepdims=True))
  probs /= probs.sum(-1, keepdims=True)
  differs = (wi != gi).any(-1)
  assert (_top_margin(probs, tcfg.topk)[differs] < ROUTE_MARGIN).all()
  same = ~differs & (np.asarray(want["keep"]) == got["keep"].numpy()).all(-1)
  assert same.mean() > 0.9
  assert got["y"].dtype == torch.bfloat16
  np.testing.assert_allclose(_np(got["y"])[same], _np(want["y"])[same],
                             rtol=2e-2, atol=2e-2)
  np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                             atol=1e-6)


def _models(arch, dtype, key=0):
  jcfg, tcfg = _cfgs(arch, dtype)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  return jcfg, tcfg, jparams, model


def _tol(dtype):
  return (dict(rtol=1e-4, atol=1e-4) if dtype == "f32"
          else dict(rtol=2e-2, atol=2e-2))


# the model's aux: f32 1e-6; bf16 2e-2, since each layer's router reads a
# residual stream that rounds to bf16 at other places in the two packages
AUX_TOL = {"f32": 1e-6, "bf16": 2e-2}


class _Routes:
  """Records every router call of both packages during a ``with`` block:
  the expert ids, and the reference's top-k margins (``_top_margin`` of its
  f32 probabilities).  The reference runs without jit, so that its scan
  over layers calls ``_route`` with concrete arrays."""

  def __init__(self, monkeypatch):
    self.ref, self.port = [], []
    j_route, t_route = jmoe._route, tmoe._route

    def ref_route(w, cfg, x):
      out = j_route(w, cfg, x)
      logits = np.asarray(x, np.float32) @ np.asarray(w, np.float32)
      probs = np.exp(logits - logits.max(-1, keepdims=True))
      probs /= probs.sum(-1, keepdims=True)
      self.ref.append((np.asarray(out[1]), _top_margin(probs, cfg.topk)))
      return out

    def port_route(w, cfg, x):
      out = t_route(w, cfg, x)
      self.port.append(out[1].numpy())
      return out
    monkeypatch.setattr(jmoe, "_route", ref_route)
    monkeypatch.setattr(tmoe, "_route", port_route)
    self._nojit = jax.disable_jit()

  def __enter__(self):
    self._nojit.__enter__()
    return self

  def __exit__(self, *exc):
    self._nojit.__exit__(*exc)

  def rows_that_agree(self, dtype):
    """Batch rows whose every route agrees (all of them in f32); a route
    that differs must sit at a margin under BF16_ROUTE_MARGIN."""
    assert len(self.ref) == len(self.port) > 0
    agree = np.ones(B, bool)
    for (ri, margin), pi in zip(self.ref, self.port):
      differs = (ri != pi).any(-1)                       # (B, S)
      if dtype == "f32":
        assert not differs.any()
      assert (margin[differs] < BF16_ROUTE_MARGIN).all(), margin[differs]
      agree &= ~differs.any(-1)
    return agree


# bf16: each layer's router reads a residual stream that rounds to bf16 at
# other places in the two packages (an ulp is 2^-8 relative), so a route
# may flip where two of the top k + 1 probabilities lie this close; a flip
# moves the rest of its row (its expert queues, and the next layers through
# attention), so values are compared on the rows where no route flipped
BF16_ROUTE_MARGIN = 2e-2


def _rows(a, rows):
  return _np(a)[rows]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_prefill_logits_cache_and_aux(arch, dtype, monkeypatch):
  jcfg, tcfg, jparams, model = _models(arch, dtype)
  toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S)).astype(
      np.int32)
  tt = torch.from_numpy(toks)
  for impl in ("pallas", "xla"):
    with _Routes(monkeypatch) as routes:
      wl, wc, wa = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                mode="prefill", impl=impl)
      gl, gc, ga = tzoo.forward(model, tcfg, {"tokens": tt}, mode="prefill",
                                impl=impl)
    rows = routes.rows_that_agree(dtype)
    assert rows.any()
    assert gl.shape == (B, 1, ttf.padded_vocab(tcfg)) == wl.shape
    np.testing.assert_allclose(_rows(gl, rows), _rows(wl, rows),
                               **_tol(dtype))
    np.testing.assert_allclose(float(ga), float(wa), atol=AUX_TOL[dtype])
    assert int(gc["len"]) == int(wc["len"]) == S
    for name in ("k", "v"):
      assert gc[name].shape == wc[name].shape
      np.testing.assert_allclose(_np(gc[name])[:, rows],
                                 _np(wc[name])[:, rows], **_tol(dtype))
  with _Routes(monkeypatch) as routes:
    wl, _, wa = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             mode="train")
    gl, _, ga = tzoo.forward(model, tcfg, {"tokens": tt}, mode="train")
  rows = routes.rows_that_agree(dtype)
  np.testing.assert_allclose(_rows(gl, rows), _rows(wl, rows), **_tol(dtype))
  np.testing.assert_allclose(float(ga), float(wa), atol=AUX_TOL[dtype])


def test_aux_is_the_mean_over_layers():
  jcfg, tcfg, _, model = _models("mixtral-8x7b", "f32")
  toks = torch.from_numpy(np.random.default_rng(8).integers(
      0, jcfg.vocab, (B, S)).astype(np.int32))
  per_layer = []

  def grab(_, __, out):
    per_layer.append(float(out[2]))
  hooks = [blk.register_forward_hook(grab) for blk in model.blocks]
  _, _, aux = tzoo.forward(model, tcfg, {"tokens": toks}, mode="train")
  for h in hooks:
    h.remove()
  assert len(per_layer) == tcfg.n_layers and len(set(per_layer)) > 1
  assert float(aux) == pytest.approx(np.mean(per_layer), rel=1e-6)
  assert all(a > 0 for a in per_layer)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype, monkeypatch):
  """One decode step on a prefilled cache seated at max_len (mixtral's is
  its 16-row window ring, written at row S % 16)."""
  from repro_torch.launch.serve import seat_cache
  jcfg, tcfg, jparams, model = _models(arch, dtype, key=3)
  s, max_len = 12, 16
  toks = np.random.default_rng(6).integers(0, jcfg.vocab, (B, s + 1)).astype(
      np.int32)
  with _Routes(monkeypatch) as routes:
    _, wc, _ = jzoo.forward(jparams, jcfg,
                            {"tokens": jnp.asarray(toks[:, :s])},
                            mode="prefill")
    full = jzoo.init_cache(jcfg, B, max_len)
    wc = jax.tree.map(lambda f, g: g.astype(f.dtype) if f.shape == g.shape
                      else jnp.pad(g, [(0, a - b) for a, b in zip(
                          f.shape, g.shape)]).astype(f.dtype), full, wc)
    wl, wc2, _ = jzoo.forward(jparams, jcfg,
                              {"tokens": jnp.asarray(toks[:, s:])},
                              mode="decode", cache=wc)
    with torch.inference_mode():
      _, gc, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
          toks[:, :s])}, mode="prefill")
      gc = seat_cache(tcfg, gc, max_len, "cpu")
      gl, gc2, _ = tzoo.forward(model, tcfg, {"tokens": torch.from_numpy(
          toks[:, s:])}, mode="decode", cache=gc)
  rows = routes.rows_that_agree(dtype)
  assert rows.any()
  np.testing.assert_allclose(_rows(gl, rows), _rows(wl, rows), **_tol(dtype))
  assert int(gc2["len"]) == int(wc2["len"]) == s + 1
  for name in ("k", "v"):
    np.testing.assert_allclose(_np(gc2[name])[:, rows],
                               _np(wc2[name])[:, rows], **_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_and_init_match_the_reference_tree(arch):
  jcfg, tcfg, jparams, model = _models(arch, "f32", key=5)
  tree = jax.tree.map(np.asarray, jparams)
  assert tzoo.param_count(model) == jzoo.param_count(jparams)
  for i, block in enumerate(model.blocks):
    np.testing.assert_array_equal(block.moe.router.numpy(),
                                  tree["blocks"]["moe"]["router"][i])
    for name, t in block.moe.experts.named_parameters():
      assert t.shape == (jcfg.n_experts,) + tree["blocks"]["moe"][
          "experts"][name].shape[2:]
      np.testing.assert_array_equal(
          t.numpy(), tree["blocks"]["moe"]["experts"][name][i])
    assert not hasattr(block, "mlp")
  drawn = tzoo.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
  assert tzoo.param_count(drawn) == jzoo.param_count(jparams)
  ptree = tzoo.param_tree(drawn)
  assert sorted(ptree["blocks"][0]) == sorted(tree["blocks"])
  assert sorted(ptree["blocks"][0]["moe"]["experts"]) == ["w1", "w2", "w3"]
  cache = tzoo.init_cache(tcfg, 2, 40, device="cpu")
  want = jzoo.init_cache(jcfg, 2, 40)
  assert cache["k"].shape == want["k"].shape
