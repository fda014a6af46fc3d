"""The port's training substrate against the reference, on the CPU.

The same weights (the reference's ``zoo.init`` tree, carried over by
``convert.from_reference``) and the same numpy batches go through both
packages' ``make_train_step`` (the reference's jitted without a mesh).

Tolerances: the optimizer's pieces rtol 1e-6 (the same f32 formulas); the
flash backward 1e-5 against ``jax.grad`` of the reference's ``_flash_xla``
in f32 (the chunk sums run in another order); one train step's loss and
grad norm rtol 1e-5 in f32, and in bf16 rtol 2e-2 for the loss and 5e-2 for
the grad norm (products round to bf16 along the way in both, in different
places); updated parameters within 2·lr, the reference's own bound
(tests/test_train.py), since Adam's rsqrt(v) amplifies rounding noise where
a gradient is near zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import xent_loss as jxent  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = ["tinyllama-1.1b", "mamba2-780m"]
# the MoE and hybrid families: the aux loss is the mean over the MoE layers
NEW_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "zamba2-7b"]
# the enc-dec and VLM families: the batch carries seamless's source frames
ENCDEC_VLM_ARCHS = ["seamless-m4t-large-v2", "chameleon-34b"]


def _cfgs(arch, dtype="f32"):
  jd, td = DTYPES[dtype]
  return (jconfigs.get_config(arch, smoke=True).replace(dtype=jd),
          tconfigs.get_config(arch, smoke=True).replace(dtype=td))


def _models(arch, dtype="f32", key=0):
  jcfg, tcfg = _cfgs(arch, dtype)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(key))
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  return jcfg, tcfg, jparams, model


def _batch(vocab, b=4, s=24, seed=0, cfg=None):
  """A batch of both packages; an enc-dec ``cfg`` adds source frames."""
  rng = np.random.default_rng(seed)
  toks = rng.integers(0, vocab, (b, s), dtype=np.int32)
  jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
  tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
  if cfg is not None and cfg.family == "encdec":
    src = rng.standard_normal((b, cfg.src_len, cfg.d_model)).astype(
        np.float32)
    jb["src_embeds"], tb["src_embeds"] = jnp.asarray(src), torch.from_numpy(
        src)
  return jb, tb


def _stacked(model):
  """The port model's parameters in the reference's stacked layout."""
  def stack(tree):
    if isinstance(tree, dict):
      return {k: stack(v) for k, v in tree.items()}
    if isinstance(tree, list):
      return jax.tree.map(lambda *xs: np.stack(xs),
                          *[stack(t) for t in tree])
    return tree.detach().float().numpy()
  return stack(tzoo.param_tree(model))


# --- loss and optimizer -------------------------------------------------------


@pytest.mark.parametrize("labels", [[1, 2, -1, 9], [0, 7, 8, 3],
                                    [-1, -1, 5, 12]])
def test_xent_loss_masks_like_the_reference(labels):
  rng = np.random.default_rng(sum(labels) + 10)
  logits = rng.standard_normal((1, 4, 8)).astype(np.float32)
  lab = np.asarray([labels], np.int32)
  want = float(jxent(jnp.asarray(logits), jnp.asarray(lab), vocab=8))
  got = float(tsteps.xent_loss(torch.from_numpy(logits),
                               torch.from_numpy(lab), vocab=8))
  np.testing.assert_allclose(got, want, rtol=1e-6)


def test_xent_loss_of_uniform_logits_is_log_vocab():
  got = tsteps.xent_loss(torch.zeros((1, 4, 8)),
                         torch.tensor([[1, 2, -1, 9]]), vocab=8)
  np.testing.assert_allclose(float(got), np.log(8), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 109, 110, 500])
def test_lr_schedule_matches_reference(step):
  jc = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_ratio=0.1)
  tc = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_ratio=0.1)
  want = float(jopt.lr_schedule(jc, jnp.asarray(step)))
  got = float(topt.lr_schedule(tc, torch.tensor(step)))
  np.testing.assert_allclose(got, want, rtol=1e-6)


def test_decay_mask_and_paths_match_reference():
  for arch in ARCHS + NEW_ARCHS + ENCDEC_VLM_ARCHS:
    _, _, jparams, model = _models(arch)
    want = sorted((p, jopt._decay_mask(p))
                  for p in jax.tree.leaves(jopt._paths(jparams)))
    tpaths = topt._leaves(topt._paths(tzoo.param_tree(model)))
    got = sorted(set((p, topt._decay_mask(p)) for p in tpaths))
    assert got == want
  assert not topt._decay_mask("blocks/ssm/A_log")
  assert topt._decay_mask("blocks/attn/wq")


def test_global_norm_and_adamw_update_match_reference():
  _, _, jparams, model = _models("tinyllama-1.1b")
  rng = np.random.default_rng(3)
  jgrads = jax.tree.map(
      lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                            * 0.3), jparams)
  oc = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0)
  jstate = jopt.init_opt_state(jparams)
  # two steps: the second has non-zero moments and bias corrections
  tparams = tzoo.param_tree(model)
  tstate = topt.init_opt_state(tparams)
  for _ in range(2):
    want_p, jstate, jm = jopt.adamw_update(jopt.AdamWConfig(**oc), jparams,
                                           jgrads, jstate)
    tgrads = _convert_grads(jgrads, tparams)
    _, tstate, tm = topt.adamw_update(topt.AdamWConfig(**oc), tparams,
                                      tgrads, tstate)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    jparams = want_p
  got = _stacked(model)
  for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(got)):
    np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)
  assert int(tstate["step"]) == int(jstate["step"]) == 2


def _convert_grads(jgrads, like):
  """The reference's stacked gradient tree in the port's layer-list tree."""
  def conv(j, t):
    if isinstance(t, dict):
      return {k: conv(j[k], v) for k, v in t.items()}
    if isinstance(t, list):
      return [conv(jax.tree.map(lambda a: a[i], j), v)
              for i, v in enumerate(t)]
    return torch.from_numpy(np.array(j, np.float32))
  return conv(jgrads, like)


# --- the flash backward -------------------------------------------------------

# (B, Sq, H, KV, hd, causal, window, chunk): causal, a sliding window, GQA
# (H 4 over KV 2 and 1), S not a multiple of the kv chunk
FLASH_CASES = [
    (2, 32, 4, 2, 16, True, None, 16),
    (1, 40, 4, 1, 8, True, 7, 16),
    (2, 24, 2, 2, 16, False, None, 64),
    (1, 37, 6, 3, 8, True, None, 10),
]


def _qkv(case, seed=0):
  b, s, h, kv, hd = case[:5]
  rng = np.random.default_rng(seed)
  return [rng.standard_normal(shape).astype(np.float32)
          for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                        (b, s, h, hd))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_jax_grad(case):
  causal, window, chunk = case[5:]
  hd = case[4]
  scale = hd ** -0.5
  q, k, v, dout = _qkv(case)

  def f(q_, k_, v_):
    out = jattn._flash_xla(q_, k_, v_, causal, window, scale, 0, chunk)
    return jnp.sum(out * dout)

  want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
  ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
  out = tattn.flash_xla(*ts, causal, window, scale, 0, chunk)
  want_out = jattn._flash_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, window, scale, 0, chunk)
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                             rtol=1e-5, atol=1e-5)
  out.backward(torch.from_numpy(dout))
  for t, w in zip(ts, want):
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_autograd_through_the_chunks(case):
  causal, window, chunk = case[5:]
  scale = case[4] ** -0.5
  q, k, v, dout = _qkv(case, seed=1)
  grads = []
  for arm in ("flash", "autodiff"):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    if arm == "flash":
      out = tattn.flash_xla(*ts, causal, window, scale, 0, chunk)
    else:
      out, _ = tattn._flash_fwd_impl(*ts, causal, window, scale, 0, chunk)
    out.backward(torch.from_numpy(dout))
    grads.append([t.grad for t in ts])
  for a, b in zip(*grads):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flash_xla_without_gradients_is_the_forward():
  q, k, v, _ = _qkv(FLASH_CASES[0])
  ts = [torch.from_numpy(x) for x in (q, k, v)]
  got = tattn.flash_xla(*ts, True, None, 0.25, 0, 16)
  want, _ = tattn._flash_fwd_impl(*ts, True, None, 0.25, 0, 16)
  assert torch.equal(got, want) and got.grad_fn is None


# --- the train step -----------------------------------------------------------


def _steps(arch, dtype, *, accum=1, remat="none", lr=1e-3, ref=True):
  """One train step of both packages on the same weights and batch (the
  reference's skipped, as (None, None), unless ``ref``)."""
  jcfg, tcfg, jparams, model = _models(arch, dtype)
  joc = jopt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
  toc = topt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
  jb, tb = _batch(tcfg.vocab, cfg=tcfg)
  jnew = jm = None
  if ref:
    (jnew, _), jm = jax.jit(jmake_train_step(jcfg, joc, accum=accum))(
        (jparams, jopt.init_opt_state(jparams)), jb)
  step = tsteps.make_train_step(tcfg, toc, accum=accum, remat=remat)
  (model, tstate), tm = step((model, topt.init_opt_state(
      tzoo.param_tree(model))), tb)
  return jnew, jm, model, tstate, tm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype):
  lr = 1e-3
  jnew, jm, model, tstate, tm = _steps(arch, dtype, lr=lr)
  loss_tol, norm_tol = (1e-5, 1e-5) if dtype == "f32" else (2e-2, 5e-2)
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                             rtol=loss_tol)
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=norm_tol)
  np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
  assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
  for a, b in zip(jax.tree.leaves(jnew), jax.tree.leaves(_stacked(model))):
    np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=2 * lr)
  assert int(tstate["step"]) == 1
  for p in tzoo.param_tree(model)["blocks"][0].values():
    for t in (p.values() if isinstance(p, dict) else [p]):
      assert t.dtype == torch.float32  # the master stays f32


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_matches_full_batch_and_reference(arch):
  """accum=2 equals accum=1 on the same global batch, and the reference's
  accum=2."""
  lr = 1e-3
  jnew, jm, model2, _, tm2 = _steps(arch, "f32", accum=2, lr=lr)
  _, _, model1, _, tm1 = _steps(arch, "f32", accum=1, lr=lr, ref=False)
  np.testing.assert_allclose(float(tm2["loss"]), float(jm["loss"]),
                             rtol=1e-5)
  np.testing.assert_allclose(float(tm2["grad_norm"]),
                             float(jm["grad_norm"]), rtol=1e-5)
  np.testing.assert_allclose(float(tm2["loss"]), float(tm1["loss"]),
                             rtol=1e-5)
  np.testing.assert_allclose(float(tm2["grad_norm"]),
                             float(tm1["grad_norm"]), rtol=1e-4)
  for a, b in zip(jax.tree.leaves(_stacked(model1)),
                  jax.tree.leaves(_stacked(model2))):
    np.testing.assert_allclose(a, b, atol=2 * lr)


@pytest.mark.parametrize("arch,remat", [("tinyllama-1.1b", "full"),
                                        ("tinyllama-1.1b", "dots"),
                                        ("mamba2-780m", "full"),
                                        ("mamba2-780m", "dots"),
                                        ("mixtral-8x7b", "full"),
                                        ("mixtral-8x7b", "dots"),
                                        ("zamba2-7b", "full"),
                                        ("zamba2-7b", "dots"),
                                        ("seamless-m4t-large-v2", "full"),
                                        ("chameleon-34b", "full"),
                                        ("chameleon-34b", "dots")])
def test_remat_matches_none(arch, remat):
  lr = 1e-3
  _, _, m0, _, t0 = _steps(arch, "f32", lr=lr, ref=False)
  _, _, m1, _, t1 = _steps(arch, "f32", remat=remat, lr=lr, ref=False)
  assert float(t1["loss"]) == pytest.approx(float(t0["loss"]), rel=1e-6)
  assert float(t1["grad_norm"]) == pytest.approx(float(t0["grad_norm"]),
                                                 rel=1e-5)
  for a, b in zip(jax.tree.leaves(_stacked(m0)),
                  jax.tree.leaves(_stacked(m1))):
    np.testing.assert_allclose(a, b, atol=2 * lr)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_moe_and_hybrid_train_step_matches_reference(arch):
  """One f32 step: loss, aux (the mean over the MoE layers; 0 for the
  hybrid), grad norm and the updated parameters against the reference's."""
  lr = 1e-3
  jnew, jm, model, tstate, tm = _steps(arch, "f32", lr=lr)
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                             rtol=1e-5)
  np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                             rtol=1e-5)
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=1e-5)
  assert (float(tm["aux_loss"]) > 0) == arch.startswith(("mixtral", "phi"))
  for a, b in zip(jax.tree.leaves(jnew), jax.tree.leaves(_stacked(model))):
    np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=2 * lr)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ENCDEC_VLM_ARCHS)
def test_encdec_and_vlm_train_step_matches_reference(arch, dtype):
  """One step with seamless's source frames in the batch (chameleon's
  from token ids): loss and grad norm against the reference's at the
  dense tolerances (f32 1e-5; bf16 2e-2 and 5e-2), aux 0, the updated
  parameters within 2·lr, the master f32."""
  lr = 1e-3
  jnew, jm, model, tstate, tm = _steps(arch, dtype, lr=lr)
  loss_tol, norm_tol = (1e-5, 1e-5) if dtype == "f32" else (2e-2, 5e-2)
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                             rtol=loss_tol)
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=norm_tol)
  assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
  for a, b in zip(jax.tree.leaves(jnew), jax.tree.leaves(_stacked(model))):
    np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=2 * lr)
  assert int(tstate["step"]) == 1
  assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("arch", ENCDEC_VLM_ARCHS)
def test_encdec_and_vlm_grad_accum(arch):
  """accum=2 against the reference's accum=2 and against accum=1 on the
  same global batch (the source frames split with their rows)."""
  lr = 1e-3
  _, jm, _, _, tm2 = _steps(arch, "f32", accum=2, lr=lr)
  _, _, _, _, tm1 = _steps(arch, "f32", accum=1, lr=lr, ref=False)
  for key in ("loss", "grad_norm"):
    np.testing.assert_allclose(float(tm2[key]), float(jm[key]), rtol=1e-5,
                               err_msg=key)
  np.testing.assert_allclose(float(tm2["loss"]), float(tm1["loss"]),
                             rtol=1e-5)
  np.testing.assert_allclose(float(tm2["grad_norm"]),
                             float(tm1["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b"])
def test_moe_and_hybrid_grad_accum(arch):
  """accum=2 against the reference's accum=2 (loss, aux and grad norm; the
  aux averaged over the microbatches as the loss is) and against accum=1
  on the same global batch: the capacity is per batch row, so the halves
  route and drop as the whole does, and the loss is the same.  The MoE
  aux is a product of two batch means (top-1 fraction × mean probability),
  not a sum over rows, so its gradient differs between the two (the
  reference's too): the grad norm is held to accum=1 only for the
  hybrid."""
  lr = 1e-3
  _, jm, _, _, tm2 = _steps(arch, "f32", accum=2, lr=lr)
  _, _, _, _, tm1 = _steps(arch, "f32", accum=1, lr=lr, ref=False)
  for key in ("loss", "aux_loss", "grad_norm"):
    np.testing.assert_allclose(float(tm2[key]), float(jm[key]), rtol=1e-5,
                               err_msg=key)
  np.testing.assert_allclose(float(tm2["loss"]), float(tm1["loss"]),
                             rtol=1e-5)
  if arch == "zamba2-7b":
    np.testing.assert_allclose(float(tm2["grad_norm"]),
                               float(tm1["grad_norm"]), rtol=1e-4)


def test_remat_dots_saves_only_the_projections():
  from torch.utils import checkpoint as ckpt_mod
  from repro_torch.models import transformer as ttf
  mm = torch.ops.aten.mm.default
  bmm = torch.ops.aten.bmm.default
  assert ttf._save_dots(None, mm) == ckpt_mod.CheckpointPolicy.MUST_SAVE
  assert ttf._save_dots(None, bmm) == (
      ckpt_mod.CheckpointPolicy.PREFER_RECOMPUTE)
  with pytest.raises(ValueError, match="remat"):
    ttf.run_layer(lambda x: x, "everything", torch.zeros(1))


@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x7b", "zamba2-7b"]
                         + ENCDEC_VLM_ARCHS)
def test_pallas_is_refused_in_training(arch):
  _, tcfg, _, model = _models(arch)
  oc = topt.AdamWConfig()
  with pytest.raises(ValueError, match="no backward"):
    tsteps.make_train_step(tcfg, oc, impl="pallas")
  # and the kernels' arms refuse operands that need gradients
  for p in topt._leaves(tzoo.param_tree(model)):
    p.requires_grad_(True)
  _, tb = _batch(tcfg.vocab, cfg=tcfg)
  with pytest.raises(RuntimeError, match="has no backward"):
    tzoo.forward(model, tcfg, tb, mode="train", impl="pallas")
  with torch.no_grad():  # serving on the same weights is untouched
    logits, _, _ = tzoo.forward(model, tcfg, tb, mode="train", impl="pallas")
  assert logits.grad_fn is None


@pytest.mark.parametrize("knob", [dict(grad_specs={}), dict(zero2=True),
                                  dict(grad_comm_bf16=True)])
def test_mesh_knobs_are_refused(knob):
  _, tcfg = _cfgs("tinyllama-1.1b")
  with pytest.raises(NotImplementedError, match="13.6"):
    tsteps.make_train_step(tcfg, topt.AdamWConfig(), **knob)


def test_serving_builds_no_autograd_graph():
  _, tcfg, _, model = _models("tinyllama-1.1b")
  _, tb = _batch(tcfg.vocab)
  logits, cache = tsteps.make_prefill_step(tcfg)(model, tb)
  assert logits.grad_fn is None and cache["k"].grad_fn is None
  assert not any(p.requires_grad for p in model.parameters())


def test_loss_decreases():
  cfg = tconfigs.get_config("tinyllama-1.1b", smoke=True)
  oc = topt.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=100)
  model = tzoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
  state = (model, topt.init_opt_state(tzoo.param_tree(model)))
  step = tsteps.make_train_step(cfg, oc)
  data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                                seed=3))
  losses = []
  for i in range(60):
    state, m = step(state, data.batch_at(i))
    losses.append(float(m["loss"]))
  assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1, losses[::10]
