"""LM serving driver: batched prefill, then greedy decode against a cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu --shards 4

Counterpart of ``repro/launch/serve.py`` for every LM family: dense, MoE,
VLM (chameleon's backbone, served on fused token streams), SSM, hybrid and
enc-dec.  The prefill runs through ``impl``: 'pallas' (the default)
launches the flash-attention kernel K3 once per attention layer (a
hybrid's: once per application of its shared block; an enc-dec model's:
once per encoder layer and twice per decoder layer, self- and
cross-attention), and the SSD intra-chunk kernel K4 once per SSM layer;
'xla' runs the plain PyTorch paths.  An enc-dec ``generate`` encodes its
source once, on ``impl``, and hands that encoder output to the prefill
and to every decode step (the reference encodes it once in ``generate``
and again, on its chunked arm, inside the prefill: the same values).
(The reference's engine builds its prefill without ``impl``, so it takes
'xla'; its steps take the argument.)  A KV cache is allocated once
at ``max_len`` (sliding-window configs get a window-sized ring buffer); an
SSM's cache is its recurrent state, which the prefill hands to the decode
as it is; a hybrid's is both.  Decode keeps the tokens on the card and
syncs once at the end.  Runs on the card (``--device cuda``, the default)
unless told otherwise.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import Shape
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.specs import cache_specs
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import encdec
from repro_torch.models import zoo
from repro_torch.train.steps import make_decode_step, make_prefill_step


def _seat_on_position(cfg, cache: dict, target: dict) -> dict:
  """One position's prefill cache seated into its ``target`` (its part of
  the decode cache): the prefill's kv heads gathered from the line's
  positions, then the heads the target holds (all, or under the 2-D cut
  its data line's group) and its rows of them (``seq_shard_decode``) or
  all of them; the SSM state as it is."""
  pos = cm.position()
  kv = cache["attn"] if cfg.family == "hybrid" else cache
  tkv = target["attn"] if cfg.family == "hybrid" else target
  s = kv["k"].shape[2]
  wholes = cm.gather_heads((kv["k"], kv["v"]), cfg.n_heads, cfg.n_kv_heads,
                           3, kv=(True, True), term="seat_kv_all_gather")
  c0, c1 = attn_mod.kv_group(cfg, tkv["k"].shape[3])
  for name, whole in zip(("k", "v"), wholes):
    rows = tkv[name].shape[2]
    row0 = rows * pos.rank if pos.seq_shard_decode else 0
    n = max(0, min(rows, s - row0))
    tkv[name][:, :, :n] = whole[:, :, row0:row0 + n, c0:c1]
  target["len"].copy_(cache["len"])
  if cfg.family == "hybrid":
    target["ssm"] = cache["ssm"]
  return target


def seat_cache(cfg, cache: dict, max_len: int, device, *,
               model=None) -> dict:
  """The prefill's cache as the decode's.

  Dense, MoE, VLM and enc-dec (the decoder's self-attention): the KV rows
  (L, B, S, ...) seated at the front of a zeroed ``max_len`` cache,
  ``len`` carried over.  SSM: the state after the
  prompt is the decode's state, in ``init_cache``'s layout already, and is
  returned as it is (the reference seats it unchanged).  Hybrid: the SSM
  state as it is, and each application's KV rows (n_apps, B, S, ...) at
  the front of a zeroed ``max_len`` cache.

  On a mesh (``model`` a ``zoo.ShardedLM``, ``cache`` the mesh prefill's
  ``PerPosition``) the head-sharded K/V are re-cut to the decode's layout,
  ``launch/specs.cache_specs``'s: with ``seq_shard_decode`` each position
  keeps its Smax/tp rows of every kv head, or, where the batch does not
  split over the data lines and they divide the kv heads, of its line's
  group of them.
  """
  if cfg.family == "ssm":
    return cache
  if model is not None:
    lines = 1 if cache.replicated else len(model.mesh.devices)
    kv = cache[(0, 0)]["attn"] if cfg.family == "hybrid" else cache[(0, 0)]
    batch = kv["k"].shape[1] * lines
    target = zoo.init_cache(
        cfg, batch, max_len, mesh=model.mesh, specs=cache_specs(
            cfg, model.par, Shape("serve", max_len, batch, "decode")))
    return model.run(lambda _, c, t: _seat_on_position(cfg, c, t), cache,
                     target)
  kv = cache["attn"] if cfg.family == "hybrid" else cache
  n, b, s = kv["k"].shape[:3]
  full = attn_mod.init_cache(cfg, n, b, max_len, device=device)
  full["k"][:, :, :s] = kv["k"]
  full["v"][:, :, :s] = kv["v"]
  full["len"].copy_(cache["len"])
  if cfg.family == "hybrid":
    return {"ssm": cache["ssm"], "attn": {"k": full["k"], "v": full["v"]},
            "len": full["len"]}
  return full


class Engine:
  """Minimal batched serving engine over the zoo API.

  With ``mesh`` (a ``launch.mesh.Mesh``) the engine serves tensor-parallel:
  it places the model's weights by ``specs_like`` under the mesh's sizes
  with fsdp and ``seq_shard_decode`` on (``zoo.shard``), the
  prompt rows split over the ``data`` lines and each line's positions
  compute on their heads, widths and vocab pieces.  A batch that does not
  split over the lines (``Parallelism.dp_for`` None: B = 1, say) goes
  whole to every line, whose caches hold only the line's group of kv
  heads where the lines divide them (the reference's 2-D cache cut); the
  lines compute the same tokens and line 0's are returned.  The first
  token is the vocab-parallel argmax of the prefill's logit pieces
  (``common.vocab_argmax``, as every decode step's).  ``device`` is where
  the prompts and the tokens live (the mesh's first device).  With
  ``seq_shard_decode`` the cache's ``max_len`` is rounded up to a multiple
  of the model axis."""

  def __init__(self, cfg, model, max_len: int = 512, *, impl: str = "pallas",
               device=DEFAULT_DEVICE, mesh=None):
    self.cfg = cfg
    self.device = resolve_device(device)
    self.mesh = mesh
    self.model = model if mesh is None else zoo.shard(cfg, model, mesh)
    if cfg.window is not None:
      max_len = min(max_len, cfg.window)
    if mesh is not None and self.model.par.seq_shard_decode:
      tp = self.model.par.tp_size   # each position holds max_len/tp rows
      max_len = -(-max_len // tp) * tp
      if cfg.window is not None and max_len > cfg.window:
        raise ValueError(f"a {cfg.window}-row window does not split over "
                         f"{tp} positions")
    self.max_len = max_len
    self.impl = impl
    self._prefill = make_prefill_step(cfg, impl=impl)
    self._decode = make_decode_step(cfg)
    # host-clock seconds of the last generate(): prefill (to the first
    # token on the host) and the decode steps after it
    self.last_timing = {}

  @torch.inference_mode()
  def generate(self, prompts: np.ndarray, n_new: int,
               src_embeds=None) -> np.ndarray:
    """prompts: (B, S) int, an array or tensor (right-aligned, already
    padded); ``src_embeds`` (B, S_src, D), an array or tensor, an enc-dec
    model's source frames.  Returns the (B, n_new) int32 greedy
    continuation."""
    s = prompts.shape[1]
    if s > self.max_len and self.cfg.family != "ssm":
      raise ValueError(f"prompt length {s} exceeds the cache's {self.max_len}")
    t0 = time.perf_counter()
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
    batch = {"tokens": tokens}
    step_batch = {}
    if self.cfg.family == "encdec":
      if src_embeds is None:
        raise ValueError(f"{self.cfg.name} needs src_embeds")
      src = torch.as_tensor(src_embeds, device=self.device)
      if self.mesh is None:
        step_batch["enc_out"] = encdec.encode(self.model, self.cfg, src,
                                              impl=self.impl)
      else:   # each position's encoder output, whole over the model axis
        step_batch["enc_out"] = self.model.run(
            lambda local, x: encdec.encode(local, self.cfg, x,
                                           impl=self.impl), src)
      batch.update(step_batch)
    last_logits, cache = self._prefill(self.model, batch)

    cache = seat_cache(self.cfg, cache, self.max_len, self.device,
                       model=None if self.mesh is None else self.model)
    tok = self._first_token(last_logits)
    out = [tok]
    tok.cpu()  # the first token on the host ends the prefill
    t1 = time.perf_counter()
    for _ in range(n_new - 1):
      tok, cache = self._decode(self.model, cache,
                                {"tokens": tok, **step_batch})
      out.append(tok)
    result = torch.cat(out, dim=1).cpu().numpy()
    t2 = time.perf_counter()
    self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                        "decode_steps": n_new - 1}
    return result


  def _first_token(self, logits):
    """The greedy first token (B, 1) int32 of the prefill's last logits;
    on a mesh the vocab-parallel argmax of their pieces, ties to the
    lowest index (the one-device argmax)."""
    if self.mesh is None:
      return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    vocab = logits.shape[1]
    pieces = zoo.PerPosition(logits.pieces,
                             replicated=logits.spec[0] is None)
    tok = self.model.lines(self.model.run(
        lambda _, piece: cm.vocab_argmax(piece, vocab), pieces))
    return tok.to(torch.int32)[:, None]


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", required=True)
  ap.add_argument("--smoke", action="store_true")
  ap.add_argument("--batch", type=int, default=4)
  ap.add_argument("--prompt-len", type=int, default=32)
  ap.add_argument("--gen", type=int, default=16)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--device", default=DEFAULT_DEVICE)
  ap.add_argument("--impl", default="pallas", choices=("pallas", "xla"))
  ap.add_argument("--shards", type=int, default=0,
                  help="serve tensor-parallel on a virtual mesh of this "
                       "many shards of --device (model axis 2)")
  args = ap.parse_args(argv)

  cfg = configs.get_config(args.arch, smoke=args.smoke)
  dev = resolve_device(args.device)
  gen = torch.Generator(device=dev).manual_seed(args.seed)
  model = zoo.init(cfg, gen, dev)
  mesh = None
  if args.shards:
    mesh = mesh_mod.make_host_mesh(model=2 if args.shards > 1 else 1,
                                   devices=[dev] * args.shards)
    print(f"[serve] mesh data={mesh.shape['data']} x "
          f"model={mesh.shape['model']} on {mesh.device_type}")
  eng = Engine(cfg, model, max_len=args.prompt_len + args.gen + 8,
               impl=args.impl, device=dev, mesh=mesh)

  rng = np.random.default_rng(args.seed)
  prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                         dtype=np.int32)
  src = None
  if cfg.family == "encdec":
    src = rng.standard_normal(
        (args.batch, cfg.src_len, cfg.d_model)).astype(np.float32)
  t0 = time.time()
  toks = eng.generate(prompts, args.gen, src_embeds=src)
  dt = time.time() - t0
  print(f"[serve] arch={cfg.name} impl={args.impl} device={dev} generated "
        f"{toks.shape} in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
  print("[serve] sample:", toks[0][:16].tolist())
  return 0


if __name__ == "__main__":
  sys.exit(main())
