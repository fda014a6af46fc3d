"""Tensor-parallel LM serving on a mesh (``zoo.shard``, ``zoo.forward`` and
the prefill and decode steps on its ``ShardedLM``, ``zoo.init_cache`` with
``mesh=``, ``launch.serve.seat_cache`` and ``Engine(mesh=…)``) on the CPU.

The smoke configs of all six families run on ``make_host_mesh(4, …,
devices=["cpu"] * 4)`` meshes shaped (2, 2) and (1, 4), with the weights
of the reference's ``zoo.init(key 0)`` (``convert.from_reference``), a
prompt of 8 tokens and 12 teacher-forced decode steps (mixtral's window of
16 rows wraps its ring buffer).  Each run is held to the port's one-device
steps on the same weights and to the reference's ``make_prefill_step`` /
``make_decode_step``, jitted with ``in_shardings`` from its ``specs_like``
and ``cache_specs`` on a (2, 4) ``jax.sharding.Mesh`` of 8 host devices
(Auto axes) under its ``activation_sharding``; the reference runs once
per module in a subprocess pinned to two cores with one intra-op thread.

Compared: the prefill's last logits, every decode step's logits (the
port's; the reference's decode step returns its greedy token, compared
for equality in f32), and the caches gathered whole after seating and
after the last step.  Tolerances: f32 rtol 1e-5 with an atol of 1e-5 of
the largest magnitude; bf16 tests/test_torch_models.py's (rtol/atol 2e-2,
and for a cache its ``_cache_tol``: atol the larger of 2e-2 and 2.5e-2 of
the largest magnitude, since a k or v row is rounded to bf16 from a
residual stream that differs by a bf16 ulp with the summation order).
"""
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.train import sharded  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["tinyllama-1.1b", "mamba2-780m", "mixtral-8x7b", "zamba2-7b",
         "seamless-m4t-large-v2", "chameleon-34b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, N = 4, 8, 12
ACT = ("data", "model", None)
# served with batches that do not split over the data lines (B = 1 and 3 on
# 2 lines): the reference's long_500k families, whose kv heads (2, 2 and
# 4; mamba2 has none) the 2 lines divide
ONE_ROW = ["h2o-danube-1.8b", "mixtral-8x7b", "mamba2-780m", "zamba2-7b"]


def _max_len(cfg) -> int:
  return 16 if cfg.window is not None else 24


_SCRIPT = textwrap.dedent("""
    import os, sys
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.configs import Shape
    from repro.launch import specs as sp
    from repro.models import common as cm
    from repro.models import encdec, zoo
    from repro.train.steps import make_decode_step, make_prefill_step

    ARCHS, DTS, B, S, N = {archs}, {dts}, {b}, {s}, {n}
    ONE_ROW = {one_row}
    DT = {{"f32": jnp.float32, "bf16": jnp.bfloat16}}

    def inputs(cfg):
      rng = np.random.default_rng(1)
      toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
      feed = rng.integers(0, cfg.vocab, (B, N), dtype=np.int32)
      src = rng.standard_normal((B, cfg.src_len or 1, cfg.d_model)).astype(
          np.float32)
      return toks, feed, src

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    par = cm.Parallelism(data_axes=("data",), tp_size=4, dp_size=2)
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    out = {{}}
    # every (arch, dtype) at B rows; then one row (B = 1 does not split
    # over "data": the batch replicated, cache_specs' 2-D cut) in f32
    runs = [(a, dt, B) for a in ARCHS for dt in DTS] + [
        (a, "f32", 1) for a in ONE_ROW]
    for arch, dt, rows in runs:
        cfg = configs.get_config(arch, smoke=True).replace(dtype=DT[dt])
        tag = f"{{arch}}/{{dt}}" + ("" if rows == B else f"/b{{rows}}")
        params = zoo.init(cfg, jax.random.PRNGKey(0))
        toks, feed, src = (x[:rows] for x in inputs(cfg))
        max_len = 16 if cfg.window is not None else 24
        shape = Shape("serve", max_len, rows, "decode")
        dp = par.dp_for(rows)
        p_specs = ns(cm.specs_like(params, cfg, par))
        c_specs = ns(sp.cache_specs(cfg, par, shape))
        ed = cfg.family == "encdec"
        with mesh, cm.activation_sharding(P(dp, "model", None)):
          pd = jax.device_put(params, p_specs)
          batch, b_specs = {{"tokens": toks}}, {{"tokens": P(dp, None)}}
          if ed:
            batch["src_embeds"] = src
            b_specs["src_embeds"] = P(dp, None, None)
          prefill = jax.jit(make_prefill_step(cfg),
                            in_shardings=(p_specs, ns(b_specs)))
          logits, cache = prefill(pd, batch)
          out[f"{{tag}}/prefill"] = np.asarray(logits.astype(jnp.float32))
          full = zoo.init_cache(cfg, rows, max_len)
          def seat(f, g):
            g = np.asarray(g)
            if f.shape == g.shape:
              return g.astype(f.dtype)
            pad = [(0, fs - gs) for fs, gs in zip(f.shape, g.shape)]
            return np.pad(g, pad).astype(f.dtype)
          cache = jax.device_put(jax.tree.map(seat, full, cache), c_specs)
          for i, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"{{tag}}/seated/{{i}}"] = np.asarray(leaf.astype(jnp.float32))
          d_specs = {{"tokens": P(dp, None)}}
          enc = None
          if ed:
            enc = np.asarray(jax.jit(lambda p, x: encdec.encode(p, cfg, x))(
                pd, src))
            d_specs["enc_out"] = P(dp, None, None)
          decode = jax.jit(make_decode_step(cfg),
                           in_shardings=(p_specs, c_specs, ns(d_specs)),
                           donate_argnums=1)
          got = []
          for t in range(N):
            step = {{"tokens": feed[:, t:t + 1]}}
            if ed:
              step["enc_out"] = enc
            tok, cache = decode(pd, cache, step)
            got.append(np.asarray(tok)[:, 0])
          out[f"{{tag}}/tokens"] = np.stack(got, axis=1)
          for i, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"{{tag}}/final/{{i}}"] = np.asarray(leaf.astype(jnp.float32))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
  out = tmp_path_factory.mktemp("tensor_parallel") / "ref.npz"
  script = _SCRIPT.format(archs=repr(ARCHS), dts=repr(sorted(DTYPES)), b=B,
                          s=S, n=N, one_row=repr(ONE_ROW))
  env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
  r = subprocess.run([sys.executable, "-c", script, str(out)],
                     capture_output=True, text=True, env=env, timeout=900)
  assert r.returncode == 0, r.stderr[-3000:]
  with np.load(out) as z:
    return {k: z[k] for k in z.files}


# --- helpers -----------------------------------------------------------------


def _model(arch, dtype="f32", **over):
  """(torch cfg, the port model on the reference's zoo.init(key 0)
  weights)."""
  jd, td = DTYPES[dtype]
  jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype=jd, **over)
  tcfg = tconfigs.get_config(arch, smoke=True).replace(dtype=td, **over)
  jparams = jzoo.init(jcfg, jax.random.PRNGKey(0))
  return tcfg, convert.from_reference(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")


def _inputs(cfg, rows=B):
  """The reference script's prompt, teacher-forced decode tokens and
  source frames (their first ``rows`` rows)."""
  rng = np.random.default_rng(1)
  toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
  feed = rng.integers(0, cfg.vocab, (B, N), dtype=np.int32)
  src = rng.standard_normal((B, cfg.src_len or 1, cfg.d_model)).astype(
      np.float32)
  return (torch.from_numpy(toks[:rows]).long(),
          torch.from_numpy(feed[:rows]).long(), torch.from_numpy(src[:rows]))


def _mesh(shape):
  return make_host_mesh(4, model=shape[1], devices=["cpu"] * 4)


def _par(shape, **knobs):
  return tcm.Parallelism(data_axes=("data",), tp_size=shape[1],
                         dp_size=shape[0], **knobs)


def _np(t):
  return t.detach().float().numpy().copy()   # a snapshot: caches change


def _whole_cache(cfg, cache, mesh, par, max_len, rows=B):
  """A mesh cache (``PerPosition``) gathered into the whole cache's leaves
  (numpy, ``init_cache``'s tree order)."""
  meta = tzoo.init_cache(cfg, rows, max_len, device="meta")
  specs = tspecs.cache_specs(cfg, par, Shape("serve", max_len, rows,
                                             "decode"))

  def walk(m, spec, pick):
    if isinstance(m, dict):
      return [leaf for k in sorted(m)
              for leaf in walk(m[k], spec[k], lambda c, k=k: pick(c)[k])]
    pieces = {pos: pick(cache[pos]) for pos in sharded.positions(mesh)}
    return [_np(sharded.gather_leaf(
        sharded.Sharded(m.shape, m.dtype, spec, mesh, pieces), "cpu"))]
  return walk(meta, specs, lambda c: c)


def _leaves(cache):
  if isinstance(cache, dict):
    return [leaf for k in sorted(cache) for leaf in _leaves(cache[k])]
  return [_np(cache)]


def _run(cfg, model, mesh=None, par=None, act=True, impl="xla", rows=B):
  """{'prefill': last logits, 'seated': cache leaves, 'decode': [logits],
  'final': cache leaves} of a prefill and N teacher-forced decode steps of
  ``rows`` rows, on one device or (with ``mesh``) tensor-parallel."""
  toks, feed, src = _inputs(cfg, rows)
  max_len = _max_len(cfg)
  batch = {"tokens": toks}
  on = None
  if mesh is not None:
    on = tzoo.shard(cfg, model, mesh, par)
  ctx = tcm.activation_sharding(ACT if act and mesh is not None else None)
  with torch.inference_mode(), ctx:
    if cfg.family == "encdec":
      batch["enc_out"] = (tencdec.encode(model, cfg, src, impl=impl)
                          if on is None else on.run(
                              lambda local, x: tencdec.encode(
                                  local, cfg, x, impl=impl), src))
    logits, cache, _ = tzoo.forward(on or model, cfg, batch, mode="prefill",
                                    impl=impl)
    cache = tserve.seat_cache(cfg, cache, max_len, "cpu", model=on)

    def leaves():
      return (_leaves(cache) if on is None else
              _whole_cache(cfg, cache, mesh, on.par, max_len, rows))
    out = {"prefill": _np(logits[:, -1]), "seated": leaves(), "decode": []}
    for t in range(N):
      step = {"tokens": feed[:, t:t + 1]}
      if "enc_out" in batch:
        step["enc_out"] = batch["enc_out"]
      logits, cache, _ = tzoo.forward(on or model, cfg, step, mode="decode",
                                      cache=cache)
      out["decode"].append(_np(logits[:, -1]))
    out["final"] = leaves()
  out["cache"] = cache
  return out


def _tol(dtype, want=None, cache=False):
  if dtype == "f32":
    scale = 1.0 if want is None else max(float(np.abs(want).max()), 1e-30)
    return dict(rtol=1e-5, atol=1e-5 * scale)
  if cache:   # k and v rows rounded from a stream a bf16 ulp apart
    return dict(rtol=2e-2,
                atol=max(2e-2, 2.5e-2 * float(np.abs(want).max())))
  return dict(rtol=2e-2, atol=2e-2)


def _same(got, want, dtype, cfg):
  np.testing.assert_allclose(got["prefill"], want["prefill"],
                             **_tol(dtype, want["prefill"]))
  for g, w in zip(got["decode"], want["decode"], strict=True):
    np.testing.assert_allclose(g, w, **_tol(dtype, w))
  for key in ("seated", "final"):
    for g, w in zip(got[key], want[key], strict=True):
      np.testing.assert_allclose(g, w, **_tol(dtype, w, cache=True))


# --- against the port's one-device steps -------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_equals_one_device(arch, shape, dtype):
  """Prefill logits, 12 decode steps' logits and the caches gathered
  whole, with every knob on (fsdp, seq_shard_decode, the sequence-sharded
  stream)."""
  cfg, model = _model(arch, dtype)
  want = _run(cfg, model)
  got = _run(cfg, model, _mesh(MESHES[shape]), _par(MESHES[shape]))
  _same(got, want, dtype, cfg)


KNOBS = [(act, fsdp, ssd) for act in (True, False) for fsdp in (True, False)
         for ssd in (True, False) if not (act and fsdp and ssd)]


@pytest.mark.parametrize("knobs", KNOBS,
                         ids=lambda k: "act{}-fsdp{}-ssd{}".format(*map(int, k)))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_knob_gives_the_same_values(arch, knobs):
  """activation_sharding off, fsdp off and seq_shard_decode off, one at a
  time and together, on the (2, 2) mesh in f32."""
  act, fsdp, ssd = knobs
  cfg, model = _model(arch)
  want = _run(cfg, model)
  shape = MESHES["2x2"]
  got = _run(cfg, model, _mesh(shape),
             _par(shape, fsdp=fsdp, seq_shard_decode=ssd), act=act)
  _same(got, want, "f32", cfg)


@pytest.mark.parametrize("n_kv", [1, 2])
def test_kv_heads_that_do_not_divide_tp(n_kv):
  """tinyllama with 4 query heads over 2 (or 1) kv heads on 4 positions:
  the kv projections are replicated (spec_for's Megatron rule) and each
  position projects only the kv head its query head reads."""
  cfg, model = _model("tinyllama-1.1b", n_kv_heads=n_kv)
  shape = MESHES["1x4"]
  on = tzoo.shard(cfg, model, _mesh(shape), _par(shape))
  wk = on.weights["blocks"][0]["attn"]["wk"]
  assert wk.spec == ("data", None, None)
  for pos, module in on.modules.items():
    assert module.blocks[0].attn.wq.shape[1] == 1
    assert module.blocks[0].attn.wk.shape[1] == 1
  _same(_run(cfg, model, _mesh(shape), _par(shape)), _run(cfg, model),
        "f32", cfg)


@pytest.mark.parametrize("n_kv", [1, 2])
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_qkv_biases_are_cut_to_each_positions_heads(shape, n_kv):
  """qwen2.5-3b's QKV biases (replicated by ``spec_for``) on each mesh, kv
  heads that tp divides or not, with seeded non-zero biases: each position
  adds the biases of its query heads and of the kv heads they read
  (``zoo.head_slice``), and the mesh's values are the one-device ones in
  f32."""
  cfg, model = _model("qwen2.5-3b", n_kv_heads=n_kv)
  assert cfg.qkv_bias
  g = torch.Generator().manual_seed(7)
  with torch.no_grad():
    for block in model.blocks:
      for name in ("bq", "bk", "bv"):
        b = getattr(block.attn, name)
        b.copy_(torch.randn(b.shape, generator=g))
  _same(_run(cfg, model, _mesh(MESHES[shape]), _par(MESHES[shape])),
        _run(cfg, model), "f32", cfg)


# --- the vocab-parallel pieces ------------------------------------------------


def _on_positions(fn, size):
  group = tcm.LineGroup(size)
  jobs = {}
  for r in range(size):
    jobs[r] = lambda r=r: fn(r)
    jobs[r].position = tcm.Position(group, r)
  return tcm.run_positions(jobs, {r: "cpu" for r in range(size)})


@pytest.mark.parametrize("vocab,size", [(12, 4), (10, 4), (9, 2)])
def test_vocab_argmax_breaks_planted_ties_to_the_lowest_index(vocab, size):
  """Rows whose maximum is planted in two or three pieces (and twice
  within one), over ceil-sized pieces with a shorter last one: the merged
  argmax is the whole row's ``torch.argmax``."""
  rng = np.random.default_rng(0)
  logits = torch.from_numpy(rng.standard_normal((6, vocab)).astype(
      np.float32))
  logits[0, [1, vocab - 1]] = 9.0
  logits[1, [vocab // 2, vocab - 2, vocab - 1]] = 9.0
  logits[2, :] = 1.0
  logits[3, [0, 1]] = 9.0
  logits[4, -1] = 9.0
  chunk = -(-vocab // size)
  got = _on_positions(lambda r: tcm.vocab_argmax(
      logits[:, r * chunk:(r + 1) * chunk], vocab), size)
  want = torch.argmax(logits, dim=-1)
  for r in range(size):
    assert torch.equal(got[r], want)


def test_vocab_parallel_embedding_is_exact():
  """Each position's rows and zeros elsewhere, summed in f32: the whole
  table's lookup bit for bit, in f32 and rounded to bf16."""
  table = torch.randn(10, 6)
  tokens = torch.tensor([[0, 3, 9, 4], [7, 2, 5, 8]])
  for dtype in (torch.float32, torch.bfloat16):
    got = _on_positions(lambda r: tcm.embed(table[r * 3:(r + 1) * 3],
                                            tokens, 10, dtype), 4)
    for r in range(4):
      assert torch.equal(got[r], table[tokens].to(dtype))


def test_a_failing_position_releases_the_others():
  """An error on one position breaks its line's meetings: the others stop
  waiting and the error is raised to the caller."""
  def fn(r):
    if r == 1:
      raise KeyError("position 1")
    return tcm.tp_sum(torch.ones(2), torch.float32)
  with pytest.raises(KeyError, match="position 1"):
    _on_positions(fn, 3)


def test_positions_take_turns_between_meetings():
  """One position runs at a time from one meeting to the next
  (``common.Baton``): the work between meetings never interleaves, and
  the order is the same on every run."""
  def run():
    log = []

    def fn(r):
      for step in range(3):
        log.append((r, step, "a"))
        log.append((r, step, "b"))
        tcm.tp_sum(torch.ones(1), torch.float32)
      return r
    _on_positions(fn, 3)
    return log
  log = run()
  assert sorted(log) == sorted((r, step, part) for step in range(3)
                               for r in range(3) for part in "ab")
  for first, second in zip(log[::2], log[1::2]):
    assert first[2] == "a" and second == first[:2] + ("b",)
  assert run() == log


def _on_grid(fn, lines, size):
  """``fn((line, rank))`` on a lines × size grid of positions, with the
  row groups and the column groups over the lines under one baton, as
  ``ShardedLM.run`` builds them."""
  keys = [(i, j) for i in range(lines) for j in range(size)]
  baton = tcm.Baton(keys)
  rows = [tcm.LineGroup(size, baton, [(i, j) for j in range(size)])
          for i in range(lines)]
  cols = [tcm.LineGroup(lines, baton, [(i, j) for i in range(lines)])
          for j in range(size)]
  jobs = {}
  for i, j in keys:
    jobs[(i, j)] = lambda k=(i, j): fn(k)
    jobs[(i, j)].position = tcm.Position(rows[i], j, column=cols[j], line=i)
  return tcm.run_positions(jobs, {k: "cpu" for k in keys})


def test_meetings_that_do_not_match_raise_instead_of_hanging():
  """A position that holds a row meeting more than its line, or a column
  meeting more than its column (interleaved with the rows' meetings),
  breaks the run with an error instead of waiting for ever."""
  def fn(r):
    for _ in range(2 if r == 0 else 1):
      tcm.tp_sum(torch.ones(1), torch.float32)
    return r
  with pytest.raises(RuntimeError, match="meetings do not match"):
    _on_positions(fn, 2)

  def column(key, extra):
    tcm.tp_sum(torch.ones(1), torch.float32)
    got = tcm.column_cat(torch.full((1,), float(key[0])), 0)
    assert got.tolist() == [0.0, 1.0]
    tcm.tp_sum(torch.ones(1), torch.float32)
    if key == extra:
      tcm.column_cat(torch.ones(1), 0)
    return key
  assert len(_on_grid(lambda k: column(k, None), 2, 2)) == 4
  with pytest.raises(RuntimeError, match="meetings do not match"):
    _on_grid(lambda k: column(k, (0, 1)), 2, 2)


# --- per-position kernels ----------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_each_position_runs_the_kernels_on_its_heads(arch, monkeypatch):
  """On impl='pallas' every position calls K3 (flash attention) and K4 (the
  SSD intra-chunk term) on its H/tp heads only, once for each of the
  one-device prefill's calls."""
  calls = []
  lock = threading.Lock()
  fa, ssd = ops.flash_attention, ops.ssd_intra_chunk

  def spy(kind, fn):
    def wrapped(*args, **kw):
      pos = tcm.position()
      with lock:
        calls.append((kind, None if pos is None else pos.rank,
                      args[0].shape[1] if kind == "K3" else args[2].shape[1]))
      return fn(*args, **kw)
    return wrapped
  monkeypatch.setattr(ops, "flash_attention", spy("K3", fa))
  monkeypatch.setattr(ops, "ssd_intra_chunk", spy("K4", ssd))
  cfg, model = _model(arch)
  shape = MESHES["2x2"]
  one = _run(cfg, model, impl="pallas")
  n_one = {k: sum(c[0] == k for c in calls) for k in ("K3", "K4")}
  calls.clear()
  got = _run(cfg, model, _mesh(shape), _par(shape), impl="pallas")
  _same(got, one, "f32", cfg)
  heads = {"K3": cfg.n_heads, "K4": cfg.ssm_heads if cfg.ssm_state else 0}
  for kind in ("K3", "K4"):
    mine = [c for c in calls if c[0] == kind]
    assert len(mine) == n_one[kind] * 4
    assert {c[2] for c in mine} <= {heads[kind] // shape[1]}
    for rank in range(shape[1]):
      assert sum(c[1] == rank for c in mine) == n_one[kind] * 2
  assert n_one["K3"] + n_one["K4"] > 0


def test_replicas_along_data_are_bit_equal():
  """Both data lines given the same rows compute them bit for bit alike,
  logits and caches."""
  cfg, model = _model("zamba2-7b", "bf16")
  shape = MESHES["2x2"]
  mesh = _mesh(shape)
  on = tzoo.shard(cfg, model, mesh, _par(shape))
  toks = _inputs(cfg)[0][:2].repeat(2, 1)
  with torch.inference_mode(), tcm.activation_sharding(ACT):
    logits, cache, _ = tzoo.forward(on, cfg, {"tokens": toks},
                                    mode="prefill")
  assert torch.equal(logits[:2], logits[2:])
  for j in range(shape[1]):
    for a, b in zip(_leaves(cache[(0, j)]), _leaves(cache[(1, j)])):
      np.testing.assert_array_equal(a, b)


# --- the engine and the command line ------------------------------------------


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_mesh_generates_the_one_device_tokens(arch, shape):
  """``Engine(mesh=…)``'s greedy tokens (K3/K4's plain versions on the
  CPU, the decode's merged vocab argmax) equal the one-device engine's in
  f32."""
  cfg, model = _model(arch)
  toks, _, src = _inputs(cfg)
  src = src if cfg.family == "encdec" else None
  one = tserve.Engine(cfg, model, max_len=22, device="cpu")
  mesh = _mesh(MESHES[shape])
  eng = tserve.Engine(cfg, model, max_len=22, device="cpu", mesh=mesh)
  want = one.generate(toks, 6, src_embeds=src)
  with tcm.activation_sharding(ACT):
    got = eng.generate(toks, 6, src_embeds=src)
  np.testing.assert_array_equal(got, want)
  assert eng.max_len % MESHES[shape][1] == 0


@pytest.mark.parametrize("arch,rows", [("tinyllama-1.1b", B),
                                       ("h2o-danube-1.8b", 1)])
def test_the_prefill_logits_stay_vocab_pieces(reference, arch, rows):
  """The mesh prefill's last logits stay where they were computed, as the
  reference's ``out_specs`` P(dp, tp) leave them: each position's piece
  is its line's rows (every row where the batch does not split) of its
  vocab piece; ``whole_logits`` gathers them onto the mesh's first
  device, equal to the reference's logits.  The cache is a
  ``PerPosition`` of each position's kv heads."""
  cfg, model = _model(arch)
  shape = MESHES["2x2"]
  mesh = _mesh(shape)
  on = tzoo.shard(cfg, model, mesh, _par(shape))
  with torch.inference_mode(), tcm.activation_sharding(ACT):
    logits, cache = tsteps.make_prefill_step(cfg)(
        on, {"tokens": _inputs(cfg, rows)[0]})
  split = rows % shape[0] == 0
  assert logits.shape == (rows, 512)
  assert logits.spec == ("data" if split else None, "model")
  for piece in logits.pieces.values():
    assert piece.shape == (rows // shape[0] if split else rows, 256)
  whole = tsteps.whole_logits(logits)
  assert whole.shape == (rows, 512) and whole.device == mesh.devices[0][0]
  want = reference[f"{arch}/f32" + ("" if split else f"/b{rows}")
                   + "/prefill"]
  np.testing.assert_allclose(_np(whole), want, **_tol("f32", want))
  assert isinstance(cache, tzoo.PerPosition) and len(cache) == 4
  assert cache.replicated is not split
  heads = cfg.n_kv_heads // shape[1]
  assert cache[(0, 0)]["k"].shape == (
      cfg.n_layers, rows // shape[0] if split else rows, S, heads, cfg.hd)


def test_steps_refuse_a_model_placed_elsewhere():
  """A model placed under a Parallelism that does not describe its mesh, a
  cache whose rows do not split over the model axis, and a run that mixes
  a cache held whole on every line with a batch split over the lines are
  refused."""
  cfg, model = _model("tinyllama-1.1b")
  on = tzoo.shard(cfg, model, _mesh((2, 2)), _par((2, 2)))
  with pytest.raises(ValueError, match="does not describe the mesh"):
    tzoo.shard(cfg, model, _mesh((2, 2)), _par((1, 4)))
  with pytest.raises(ValueError, match="does not split"):
    tzoo.init_cache(cfg, B, 21, mesh=on.mesh, specs=tspecs.cache_specs(
        cfg, on.par, Shape("serve", 21, B, "decode")))
  one_row = tzoo.init_cache(cfg, 1, 16, mesh=on.mesh, specs=tspecs.cache_specs(
      cfg, on.par, Shape("serve", 16, 1, "decode")))
  assert one_row.replicated
  with pytest.raises(ValueError, match="mixes"):
    tsteps.make_decode_step(cfg)(on, one_row,
                                 {"tokens": _inputs(cfg)[0][:2, :1]})


# --- a batch that does not split over the data lines ---------------------------


def _lines_spy(monkeypatch):
  """Hold every run whose lines computed the whole batch to lines that
  agree bit for bit (each line's first position's result); returns the
  runs checked."""
  checked = []
  lines = tzoo.ShardedLM.lines

  def spy(self, out, index=None):
    if out.replicated:
      pick = [out[(i, 0)] if index is None else out[(i, 0)][index]
              for i in range(len(self.mesh.devices))]
      for other in pick[1:]:
        assert torch.equal(other, pick[0])
      checked.append(len(pick))
    return lines(self, out, index)
  monkeypatch.setattr(tzoo.ShardedLM, "lines", spy)
  return checked


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("arch", ONE_ROW)
def test_a_batch_that_does_not_split_runs_whole_on_every_line(
    arch, rows, monkeypatch):
  """B = 1 and B = 3 on the (2, 2) mesh in f32: every line computes the
  whole batch (the reference's ``dp_for`` None) and the lines agree bit
  for bit (logits, tokens, the state replicated over them); the prefill
  and decode logits and the caches gathered whole equal the one-device
  run's; each KV piece holds its line's n_kv/2 heads and its Smax/2 rows;
  the engine's tokens are the one-device engine's."""
  cfg, model = _model(arch)
  shape = MESHES["2x2"]
  want = _run(cfg, model, rows=rows)
  checked = _lines_spy(monkeypatch)
  got = _run(cfg, model, _mesh(shape), _par(shape), rows=rows)
  _same(got, want, "f32", cfg)
  assert checked == [2] * (1 + N)
  cache = got["cache"]
  kv = {"hybrid": "attn"}.get(cfg.family)
  for (i, j), mine in cache.items():
    if cfg.family != "ssm":
      k = (mine[kv] if kv else mine)["k"]
      assert k.shape[1:] == (rows, _max_len(cfg) // shape[1],
                             cfg.n_kv_heads // shape[0], cfg.hd)
    if cfg.ssm_state:  # the SSM state is replicated over the lines
      for a, b in zip(_leaves(mine["ssm"]), _leaves(cache[(1 - i, j)]["ssm"])):
        np.testing.assert_array_equal(a, b)
  toks = _inputs(cfg, rows)[0]
  one = tserve.Engine(cfg, model, max_len=16, device="cpu").generate(toks, 6)
  eng = tserve.Engine(cfg, model, max_len=16, device="cpu",
                      mesh=_mesh(shape))
  with tcm.activation_sharding(ACT):
    np.testing.assert_array_equal(eng.generate(toks, 6), one)


@pytest.mark.parametrize("arch", ONE_ROW)
def test_one_row_matches_the_reference(reference, arch):
  """B = 1 on the (2, 2) mesh against the reference's prefill and decode
  steps jitted with ``dp_for(1)`` batch specs and the 2-D ``cache_specs``
  on its (2, 4) mesh, in f32: prefill logits, the caches gathered whole
  after seating and after the last step, and each decode step's greedy
  token."""
  cfg, model = _model(arch)
  got = _run(cfg, model, _mesh(MESHES["2x2"]), _par(MESHES["2x2"]), rows=1)
  _against_reference(got, reference, f"{arch}/f32/b1", "f32")


def test_the_serve_command_runs_on_cpu_shards():
  r = subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
       "zamba2-7b", "--smoke", "--batch", "2", "--prompt-len", "8", "--gen",
       "4", "--device", "cpu", "--shards", "4"],
      capture_output=True, text=True, timeout=300,
      env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
  assert r.returncode == 0, r.stderr[-2000:]
  assert "mesh data=2 x model=2 on cpu" in r.stdout
  assert "generated (2, 4)" in r.stdout


# --- against the reference's mesh-sharded steps ------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_equals_the_reference(reference, arch, shape, dtype):
  """The port on its mesh against the reference's steps on a (2, 4)
  jax.sharding.Mesh: prefill logits, the seated and final caches gathered
  whole, and (f32) each decode step's greedy token against the argmax of
  the port's logits."""
  cfg, model = _model(arch, dtype)
  got = _run(cfg, model, _mesh(MESHES[shape]), _par(MESHES[shape]))
  # an MoE router in bf16 may flip a route where two probabilities nearly
  # tie (tests/test_torch_moe.py): the cache rows after a flip are held to
  # the reference where the port's one-device run agrees with it, and to
  # that run everywhere
  one = _run(cfg, model) if cfg.n_experts and dtype == "bf16" else None
  _against_reference(got, reference, f"{arch}/{dtype}", dtype, one)


def _against_reference(got, reference, tag, dtype, one=None):
  np.testing.assert_allclose(got["prefill"], reference[f"{tag}/prefill"],
                             **_tol(dtype, reference[f"{tag}/prefill"]))
  for key in ("seated", "final"):
    want = [reference[f"{tag}/{key}/{i}"] for i in range(len(got[key]))]
    assert f"{tag}/{key}/{len(got[key])}" not in reference
    for i, (g, w) in enumerate(zip(got[key], want)):
      tol = _tol(dtype, w, cache=True)
      if one is not None:
        np.testing.assert_allclose(g, one[key][i], **tol)
        agree = np.isclose(one[key][i], w, **tol)
        assert agree.mean() > 0.99
        g, w = g[agree], w[agree]
      np.testing.assert_allclose(g, w, **tol)
  if dtype == "f32":
    tokens = np.stack([d.argmax(-1) for d in got["decode"]], axis=1)
    np.testing.assert_array_equal(tokens, reference[f"{tag}/tokens"])
