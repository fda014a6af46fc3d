"""The port's LM serving engine against the reference's, on the CPU.

Both engines get the same weights (``convert.from_reference``) and the same
numpy prompts.  The reference ``Engine`` builds its prefill without
``impl`` (its 'xla' arm); the port's takes ``impl``, so it is held against
that engine on both arms, and its 'pallas' prefill against a reference
prefill step built with ``impl="pallas"`` (the Pallas kernel in interpret
mode).

The MoE and hybrid configs (mixtral-8x7b, phi3.5-moe, zamba2-7b) are held
the same way in f32 (in bf16 the 8× head spreads their deeper stacks'
rounding differences past the 2e-2 gap: zamba2's prefill logits differ by
up to 0.086 there, 0.011 before the scaling), and their
engine's greedy tokens against the port's own full-context forward under
the reference's rule for that check (tests/test_serve.py): a token that
differs must be within 0.1 of the argmax in logit for MoE (a router
near-tie swaps experts and moves logits by more than the tie gap) and
2e-2 otherwise.

Greedy tokens are compared under the reference's near-tie rule
(tests/test_serve.py): position by position, up to the first step at which
the reference's own logits put the top two tokens within 2e-2 of each other
in bf16 (1e-4 in f32, the f32 tolerance) — rounding in two frameworks may
break such a tie either way, and the continuations differ from there.  For
the token comparison the LM head is scaled up 8× in both packages, so that
the smoke models' logits spread (std ≈ 1.3 instead of 0.16) and bf16
near-ties are rare.  Prefill
logits: f32 rtol/atol 1e-4; bf16 2e-2, the reference's own bf16 tolerance
(tests/test_models.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import Engine as JEngine  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train.steps import make_prefill_step  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen2.5-3b", "granite-8b", "h2o-danube-1.8b",
         "chameleon-34b"]
NEW_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "zamba2-7b"]
B, S, N_NEW, MAX_LEN = 2, 12, 6, 48
TIE_GAP = {"bf16": 2e-2, "f32": 1e-4}


def _setup(arch, dtype, head_scale=1):
  jd, td = {"f32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
  jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype=jd)
  tcfg = tconfigs.get_config(arch, smoke=True).replace(dtype=td)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(2))
  jparams["lm_head"] = jparams["lm_head"] * head_scale
  model = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
  prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (B, S),
                                              dtype=np.int32)
  return jcfg, tcfg, jparams, model, prompts


def _comparable_steps(jparams, jcfg, prompts, toks, gap):
  """Per row: the steps before the first near-tie of the reference's own
  logits along its own tokens."""
  n = toks.shape[1]
  ok = np.full(B, n)
  ctx = jnp.asarray(prompts, jnp.int32)
  for t in range(n):
    logits, _, _ = jzoo.forward(jparams, jcfg, {"tokens": ctx}, mode="train")
    lg = np.asarray(logits[:, -1], np.float32)
    top2 = np.sort(lg, axis=-1)[:, -2:]
    for b in range(B):
      if ok[b] == n and top2[b, 1] - top2[b, 0] < gap:
        ok[b] = t
    ctx = jnp.concatenate([ctx, jnp.asarray(toks[:, t:t + 1], jnp.int32)],
                          axis=1)
  return ok


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch, dtype):
  jcfg, tcfg, jparams, model, prompts = _setup(arch, dtype, head_scale=8)
  want = JEngine(jcfg, jparams, max_len=MAX_LEN).generate(prompts, N_NEW)
  ok = _comparable_steps(jparams, jcfg, prompts, want, TIE_GAP[dtype])
  for impl in ("pallas", "xla"):
    eng = tserve.Engine(tcfg, model, max_len=MAX_LEN, impl=impl,
                        device="cpu")
    got = eng.generate(prompts, N_NEW)
    assert got.shape == (B, N_NEW) and got.dtype == np.int32
    assert eng.max_len == (min(MAX_LEN, tcfg.window) if tcfg.window
                           else MAX_LEN)
    for b in range(B):
      np.testing.assert_array_equal(got[b, :ok[b]], want[b, :ok[b]],
                                    err_msg=f"{arch} {impl} row {b}")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_moe_and_hybrid_engines_match_reference_engine(arch):
  jcfg, tcfg, jparams, model, prompts = _setup(arch, "f32", head_scale=8)
  want = JEngine(jcfg, jparams, max_len=MAX_LEN).generate(prompts, N_NEW)
  ok = _comparable_steps(jparams, jcfg, prompts, want, TIE_GAP["f32"])
  for impl in ("pallas", "xla"):
    eng = tserve.Engine(tcfg, model, max_len=MAX_LEN, impl=impl,
                        device="cpu")
    got = eng.generate(prompts, N_NEW)
    assert got.shape == (B, N_NEW) and got.dtype == np.int32
    for b in range(B):
      np.testing.assert_array_equal(got[b, :ok[b]], want[b, :ok[b]],
                                    err_msg=f"{arch} {impl} row {b}")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_matches_full_context(arch, impl):
  """The port's version of tests/test_serve.py::test_engine_matches_full_context
  on the MoE and hybrid configs (bf16, as configured)."""
  from repro_torch.models import zoo
  cfg = tconfigs.get_config(arch, smoke=True)
  model = zoo.init(cfg, torch.Generator().manual_seed(2), device="cpu")
  eng = tserve.Engine(cfg, model, max_len=MAX_LEN, impl=impl, device="cpu")
  prompts = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                              dtype=np.int32)
  toks = eng.generate(prompts, N_NEW)
  assert toks.shape == (B, N_NEW)
  tol = 0.1 if cfg.n_experts else 2e-2
  ctx = torch.from_numpy(prompts).long()
  with torch.inference_mode():
    for t in range(N_NEW):
      logits, _, _ = zoo.forward(model, cfg, {"tokens": ctx}, mode="train")
      lg = logits[:, -1].float()
      nxt = lg.argmax(dim=-1)
      for b in range(B):
        if toks[b, t] != int(nxt[b]):
          assert abs(float(lg[b, toks[b, t]] - lg[b, nxt[b]])) < tol, (t, b)
      ctx = torch.cat([ctx, torch.from_numpy(toks[:, t:t + 1]).long()], 1)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_prefill_matches_reference_pallas_prefill(arch, dtype):
  jcfg, tcfg, jparams, model, prompts = _setup(arch, dtype)
  wl, wc = j_make_prefill_step(jcfg, impl="pallas")(
      jparams, {"tokens": jnp.asarray(prompts)})
  with torch.inference_mode():
    gl, gc = make_prefill_step(tcfg, impl="pallas")(
        model, {"tokens": torch.from_numpy(prompts).long()})
  tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "f32"
         else dict(rtol=2e-2, atol=2e-2))
  np.testing.assert_allclose(gl.float().numpy(),
                             np.asarray(wl, np.float32), **tol)
  for name in ("k", "v"):
    np.testing.assert_allclose(gc[name].float().numpy(),
                               np.asarray(wc[name], np.float32), **tol)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_main_runs_on_the_cpu(impl, capsys):
  rc = tserve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--gen", "10", "--device", "cpu",
                    "--impl", impl])
  assert rc == 0
  out = capsys.readouterr().out
  assert f"impl={impl}" in out and "generated (2, 10)" in out


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_main_serves_moe_and_hybrid_on_the_cpu(arch, impl, capsys):
  rc = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--gen", "6", "--device", "cpu",
                    "--impl", impl])
  assert rc == 0
  out = capsys.readouterr().out
  assert f"arch={arch}" in out and "generated (2, 6)" in out


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_main_serves_mamba2_on_the_cpu(impl, capsys):
  rc = tserve.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                    "--impl", impl])
  assert rc == 0
  out = capsys.readouterr().out
  assert "arch=mamba2-780m" in out and "generated (4, 16)" in out


def test_main_refuses_a_family_not_ported_yet():
  """Every architecture of the reference's registry is ported (the enc-dec
  and VLM ones serve in tests/test_torch_encdec.py and
  tests/test_torch_vlm.py); a name outside the registry is refused."""
  with pytest.raises(KeyError, match="no-such-arch"):
    tserve.main(["--arch", "no-such-arch", "--smoke", "--device", "cpu"])


def test_engine_refuses_a_prompt_longer_than_the_cache():
  cfg = tconfigs.get_config("h2o-danube-1.8b", smoke=True)  # window 16
  from repro_torch.models import zoo
  model = zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
  eng = tserve.Engine(cfg, model, max_len=64, device="cpu")
  assert eng.max_len == 16
  with pytest.raises(ValueError, match="exceeds"):
    eng.generate(np.zeros((1, 17), np.int32), 2)


@pytest.mark.parametrize("arch,max_len,limit", [("mixtral-8x7b", 64, 16),
                                                ("zamba2-7b", 12, 12)])
def test_moe_and_hybrid_engines_refuse_a_prompt_longer_than_the_cache(
    arch, max_len, limit):
  """The prompt-length check holds for MoE (mixtral's smoke window of 16
  caps its cache) and for the hybrid (its KV slices), as for dense."""
  from repro_torch.models import zoo
  cfg = tconfigs.get_config(arch, smoke=True)
  model = zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
  eng = tserve.Engine(cfg, model, max_len=max_len, device="cpu")
  assert eng.max_len == limit
  with pytest.raises(ValueError, match="exceeds"):
    eng.generate(np.zeros((1, limit + 1), np.int32), 2)
