"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
llama-family model for a few hundred steps, with checkpointing.  (The same
launcher drives the full configs.)

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --smoke \\
        --steps 20 --seq 64 --shards 8

Counterpart of ``examples/train_lm.py``.  It registers llama-100m on the
port's config registry, as the reference registers it on its own, and runs
``launch/train.py`` on the mesh that driver builds (one shard per device
of ``--device``'s type, or ``--shards`` shards of it).  ``--smoke`` trains
the registered smoke config; ``--batch``, ``--seq`` and ``--lr`` (default
the reference's 8, 512 and 3e-4) size a quick run.  The check: the last
logged loss is below the first.
"""
import argparse
import contextlib
import io
import os
import sys
import tempfile
import types

from repro_torch.launch import train as train_mod
from repro_torch.models.common import ModelConfig


class _Tee(io.StringIO):
  """Keeps what is written and passes it on to stdout."""

  def write(self, text):
    sys.__stdout__.write(text)
    return super().write(text)


def _losses(text: str) -> list:
  return [float(line.split("loss=")[1].split()[0])
          for line in text.splitlines() if "loss=" in line]


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=300)
  ap.add_argument("--ckpt-dir",
                  default=os.path.join(tempfile.gettempdir(),
                                       "simd2_train_lm"))
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--smoke", action="store_true",
                  help="train the registered smoke config")
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=512)
  ap.add_argument("--shards", type=int, default=0)
  ap.add_argument("--lr", type=float, default=3e-4)
  args = ap.parse_args(argv)

  # ~100M-param llama-family config (registered ad hoc — any entry in
  # src/repro_torch/configs works the same way via --arch)
  import repro_torch.configs as configs
  cfg100m = ModelConfig(
      name="llama-100m", family="dense", n_layers=12, d_model=768,
      n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000, head_dim=64)
  configs._ARCHS["llama-100m"] = "llama_100m"
  mod = types.ModuleType("repro_torch.configs.llama_100m")
  mod.CONFIG = cfg100m
  mod.smoke_config = lambda: cfg100m.replace(n_layers=2, d_model=128,
                                             d_ff=256, vocab=1024)
  sys.modules["repro_torch.configs.llama_100m"] = mod

  n_params = 12 * (3 * 768 * 2048 + 768 * (12 + 8) * 64 + 768 * 768) \
      + 2 * 32000 * 768
  print(f"llama-100m ≈ {n_params / 1e6:.0f}M params; training "
        f"{args.steps} steps on the host mesh …", flush=True)
  flags = ["--arch", "llama-100m", "--steps", str(args.steps),
           "--batch", str(args.batch), "--seq", str(args.seq),
           "--lr", str(args.lr), "--ckpt-dir", args.ckpt_dir,
           "--ckpt-every", "100", "--log-every", "20",
           "--device", args.device, "--shards", str(args.shards)]
  out = _Tee()
  with contextlib.redirect_stdout(out):
    rc = train_mod.main(flags + (["--smoke"] if args.smoke else []))
  losses = _losses(out.getvalue())
  ok = rc == 0 and len(losses) >= 2 and losses[-1] < losses[0]
  print(f"loss {losses[0] if losses else None} → "
        f"{losses[-1] if losses else None}, fell: {ok}")
  print(f"[checks] {int(ok)} of 1 passed")
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
