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
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models import zoo
from repro_torch.train.steps import make_decode_step, make_prefill_step


def seat_cache(cfg, cache: dict, max_len: int, device) -> dict:
  """The prefill's cache as the decode's.

  Dense, MoE, VLM and enc-dec (the decoder's self-attention): the KV rows
  (L, B, S, ...) seated at the front of a zeroed ``max_len`` cache,
  ``len`` carried over.  SSM: the state after the
  prompt is the decode's state, in ``init_cache``'s layout already, and is
  returned as it is (the reference seats it unchanged).  Hybrid: the SSM
  state as it is, and each application's KV rows (n_apps, B, S, ...) at
  the front of a zeroed ``max_len`` cache.
  """
  if cfg.family == "ssm":
    return cache
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
  """Minimal batched serving engine over the zoo API."""

  def __init__(self, cfg, model, max_len: int = 512, *, impl: str = "pallas",
               device=DEFAULT_DEVICE):
    self.cfg = cfg
    self.device = resolve_device(device)
    self.model = model
    if cfg.window is not None:
      max_len = min(max_len, cfg.window)
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
      step_batch["enc_out"] = encdec.encode(self.model, self.cfg, src,
                                            impl=self.impl)
      batch.update(step_batch)
    last_logits, cache = self._prefill(self.model, batch)

    cache = seat_cache(self.cfg, cache, self.max_len, self.device)
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
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
  args = ap.parse_args(argv)

  cfg = configs.get_config(args.arch, smoke=args.smoke)
  dev = resolve_device(args.device)
  gen = torch.Generator(device=dev).manual_seed(args.seed)
  model = zoo.init(cfg, gen, dev)
  eng = Engine(cfg, model, max_len=args.prompt_len + args.gen + 8,
               impl=args.impl, device=dev)

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
