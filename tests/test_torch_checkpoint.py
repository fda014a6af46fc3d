"""The port's checkpoints and data pipeline, on the CPU: atomic commit,
exact resume, the layout on disk shared with the reference, and batches
that are pure functions of (seed, step, host)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import PackedCorpus as JPackedCorpus  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import (DataConfig, PackedCorpus, SyntheticLM,  # noqa: E402
                              make_source)
from repro_torch.data.pipeline import Prefetcher  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_atomic_commit(tmp_path):
  d = str(tmp_path)
  state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
  ckpt.save(d, 10, state)
  assert ckpt.latest_step(d) == 10
  ckpt.save(d, 20, {"a": state["a"] * 2})
  assert ckpt.latest_step(d) == 20
  out, step = ckpt.restore(d)
  assert step == 20
  np.testing.assert_array_equal(out["a"], state["a"] * 2)
  # older checkpoint still restorable explicitly
  out10, _ = ckpt.restore(d, step=10)
  np.testing.assert_array_equal(out10["a"], state["a"])
  assert sorted(os.listdir(d)) == ["LATEST", "step_00000010", "step_00000020"]


def test_restore_missing_raises(tmp_path):
  with pytest.raises(FileNotFoundError):
    ckpt.restore(str(tmp_path))


def _train_state(seed=0):
  cfg = tconfigs.get_config("tinyllama-1.1b", smoke=True)
  model = tzoo.init(cfg, torch.Generator().manual_seed(seed), "cpu")
  params = tzoo.param_tree(model)
  opt = topt.init_opt_state(params)
  with torch.no_grad():
    for m in topt._leaves(opt["m"]):
      m.normal_(generator=torch.Generator().manual_seed(seed + 1))
  opt["step"] = torch.tensor(7, dtype=torch.int32)
  return {"params": params, "opt": opt}


def _assert_trees_equal(a, b):
  la, lb = topt._leaves(a), topt._leaves(b)
  assert len(la) == len(lb)
  for x, y in zip(la, lb):
    assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_layer_lists_are_written_stacked_and_restored_in_place(tmp_path):
  state = _train_state()
  ckpt.save(str(tmp_path), 5, state)
  raw, step = ckpt.restore(str(tmp_path))
  assert step == 5
  wq = raw["params"]["blocks"]["attn"]["wq"]
  assert wq.shape == (2, 64, 4, 16)  # (L, d, h, hd), the reference's
  template = _train_state(seed=3)
  back, _ = ckpt.restore(str(tmp_path), template=template)
  _assert_trees_equal(back, state)
  assert back["opt"]["step"].dtype == torch.int32
  assert isinstance(back["params"]["blocks"], list)


def test_async_checkpointer_round_trip(tmp_path):
  state = _train_state()
  ac = ckpt.AsyncCheckpointer(str(tmp_path))
  embed3 = state["params"]["embed"].clone()
  ac.save(3, state)
  # the snapshot is taken at save(): later writes do not reach the file
  with torch.no_grad():
    state["params"]["embed"].add_(1.0)
  ac.save(4, state)
  ac.wait()
  assert ckpt.latest_step(str(tmp_path)) == 4
  three, _ = ckpt.restore(str(tmp_path), template=_train_state(1), step=3)
  assert torch.equal(three["params"]["embed"], embed3)
  four, _ = ckpt.restore(str(tmp_path), template=_train_state(1))
  _assert_trees_equal(four, state)


def test_reads_a_checkpoint_the_reference_wrote(tmp_path):
  state = _train_state()
  arrays = jax.tree.map(np.asarray, ckpt._flatten(state))
  jckpt.save(str(tmp_path), 12, ckpt._unflatten(arrays))
  back, step = ckpt.restore(str(tmp_path), template=_train_state(2))
  assert step == 12
  _assert_trees_equal(back, state)
  # and the reference reads the port's
  ckpt.save(str(tmp_path / "port"), 13, state)
  ref, rstep = jckpt.restore(str(tmp_path / "port"))
  assert rstep == 13
  for path, a in ckpt._flatten(state).items():
    node = ref
    for part in path.split("/"):
      node = node[part]
    np.testing.assert_array_equal(np.asarray(node), a)


@pytest.mark.parametrize("arch,path,shape", [
    ("mixtral-8x7b", "params/blocks/moe/experts/w1", (2, 4, 64, 128)),
    ("phi3.5-moe-42b-a6.6b", "params/blocks/moe/router", (2, 64, 4)),
    ("zamba2-7b", "params/shared/attn/wq", (64, 4, 16)),
    ("seamless-m4t-large-v2", "params/dec/cross/wk", (2, 64, 4, 16)),
    ("seamless-m4t-large-v2", "params/enc/mlp/w1", (2, 64, 128)),
    ("seamless-m4t-large-v2", "params/enc_norm_scale", (64,)),
    ("chameleon-34b", "params/blocks/attn/k_norm_scale", (2, 16)),
])
def test_reads_the_reference_checkpoint_of_each_family(tmp_path, arch, path,
                                                       shape):
  """The reference's own ``zoo.init`` tree, written by the reference's
  checkpointer (MoE experts stacked (L, E, D, F); a hybrid's shared block
  with no layer axis; an enc-dec model's ``enc`` and ``dec`` stacked
  apart; a VLM's q/k norm scales), restores into a port model's tree equal to
  ``convert.from_reference`` of the same tree; the port writes it back in
  the same layout."""
  from repro import configs as jconfigs
  from repro.models import zoo as jzoo
  from repro_torch.models import convert
  jcfg = jconfigs.get_config(arch, smoke=True)
  tcfg = tconfigs.get_config(arch, smoke=True)
  tree = jax.tree.map(np.asarray, jzoo.init(jcfg, jax.random.PRNGKey(1)))
  jckpt.save(str(tmp_path / "ref"), 4, {"params": tree})
  template = {"params": tzoo.param_tree(
      tzoo.init(tcfg, torch.Generator().manual_seed(0), "cpu"))}
  back, step = ckpt.restore(str(tmp_path / "ref"), template=template)
  assert step == 4
  want = tzoo.param_tree(convert.from_reference(tree, tcfg, device="cpu"))
  _assert_trees_equal(back["params"], want)
  ckpt.save(str(tmp_path / "port"), 5, back)
  flat = ckpt._flatten(back)
  assert flat[path].shape == shape
  ref, _ = jckpt.restore(str(tmp_path / "port"))
  node = ref
  for part in path.split("/"):
    node = node[part]
  np.testing.assert_array_equal(np.asarray(node), flat[path])


# --- data ---------------------------------------------------------------------


@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1)])
def test_packed_corpus_equals_the_reference_bit_for_bit(tmp_path, hosts):
  toks = (np.arange(10000, dtype=np.uint16) * 7) % 50
  path = tmp_path / "corpus.bin"
  toks.tofile(path)
  kw = dict(vocab=50, seq_len=32, global_batch=4, seed=1,
            corpus_path=str(path))
  ours = PackedCorpus(DataConfig(**kw), *hosts)
  ref = JPackedCorpus(JDataConfig(**kw), *hosts)
  for step in (0, 1, 17):
    got, want = ours.batch_at(step), ref.batch_at(step)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["labels"] is got["tokens"]


def test_synthetic_lm_is_deterministic_and_sharded():
  cfg = DataConfig(vocab=100, seq_len=16, global_batch=8, seed=7)
  a = SyntheticLM(cfg).batch_at(3)["tokens"]
  assert torch.equal(a, SyntheticLM(cfg).batch_at(3)["tokens"])
  assert not torch.equal(a, SyntheticLM(cfg).batch_at(4)["tokens"])
  h0 = SyntheticLM(cfg, n_hosts=2, host_id=0).batch_at(3)["tokens"]
  h1 = SyntheticLM(cfg, n_hosts=2, host_id=1).batch_at(3)["tokens"]
  assert h0.shape == (4, 16) and not torch.equal(h0, h1)
  other_seed = DataConfig(vocab=100, seq_len=16, global_batch=8, seed=8)
  assert not torch.equal(a, SyntheticLM(other_seed).batch_at(3)["tokens"])


def test_synthetic_lm_has_its_structure():
  """Each token is its predecessor plus a step in [1, 17), times 31 on the
  noise mask, mod V."""
  v = 32000
  toks = SyntheticLM(DataConfig(vocab=v, seq_len=512, global_batch=16,
                                seed=0)).batch_at(0)["tokens"].long()
  assert toks.dtype == torch.int64 and toks.min() >= 0 and toks.max() < v
  d = (toks[:, 1:] - toks[:, :-1]) % v
  plain = (d >= 1) & (d < 17)
  noisy = (d % 31 == 0) & (d // 31 >= 1) & (d // 31 < 17)
  assert bool((plain | noisy).all())
  share = float(((d >= 17)).float().mean())
  assert 0.07 < share < 0.13  # the 10 % noise mask


def test_prefetcher_equals_the_synchronous_source():
  src = SyntheticLM(DataConfig(vocab=50, seq_len=8, global_batch=2, seed=5))
  pre = Prefetcher(src, depth=2)
  for step in [0, 1, 2, 5, 6, 3, 4]:  # in order, then skipping, then back
    assert torch.equal(pre.batch_at(step)["tokens"],
                       src.batch_at(step)["tokens"])
  assert isinstance(make_source(src.cfg, prefetch=2), Prefetcher)
  assert isinstance(make_source(src.cfg), SyntheticLM)


def test_prefetcher_keeps_at_most_depth_batches():
  src = SyntheticLM(DataConfig(vocab=50, seq_len=8, global_batch=2, seed=5))
  pre = Prefetcher(src, depth=1)
  pre._prefetch(10)
  pre._prefetch(11)
  with pre._lock:
    assert list(pre._ready) == [10]
  pre.batch_at(12)  # a later step drops what was never asked for
  with pre._lock:
    assert 10 not in pre._ready


# --- kill and resume ------------------------------------------------------------


def _run_train(args):
  return subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]
      + args, capture_output=True, text=True, timeout=600,
      env=dict(os.environ, PYTHONPATH=SRC))


def _loss_of(stdout):
  line = [ln for ln in stdout.splitlines() if "loss=" in ln][-1]
  return float(line.split("loss=")[1].split()[0])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m"])
def test_kill_and_resume_exact(tmp_path, arch):
  """Train 1→30 with a simulated node failure at step 20; resume must give
  the uninterrupted run's final loss (stateless data + committed state =
  exact restart), as the reference's test schedules it."""
  common = ["--arch", arch, "--smoke", "--steps", "30", "--batch", "4",
            "--seq", "32", "--lr", "1e-3", "--ckpt-every", "10",
            "--log-every", "30"]
  r = _run_train(common + ["--ckpt-dir", str(tmp_path / "ref")])
  assert r.returncode == 0, r.stderr
  crash = tmp_path / "crash"
  r1 = _run_train(common + ["--ckpt-dir", str(crash), "--fail-at", "20"])
  assert r1.returncode == 42, r1.stderr  # simulated failure
  assert ckpt.latest_step(str(crash)) == 20
  r2 = _run_train(common + ["--ckpt-dir", str(crash), "--async-ckpt"])
  assert r2.returncode == 0, r2.stderr
  assert "resumed from step 20" in r2.stdout
  np.testing.assert_allclose(_loss_of(r2.stdout), _loss_of(r.stdout),
                             rtol=1e-5)
  assert ckpt.latest_step(str(crash)) == 30
