"""LM serving on the PyTorch/CUDA port: batched prefill + decode through
``launch/serve.Engine`` with a reduced config (the path the decode_* dry-run
shapes count).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x7b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Counterpart of ``examples/serve_lm.py``: the driver's ``main`` on the smoke
config, 4 prompts of 24 tokens, 16 new tokens each; on the card the
prefill's attention is the flash attention kernel (K3).  Extra arguments
(``--arch``, ``--device``, ``--impl``) go to the driver.
"""
import sys

from repro_torch.launch import serve as serve_mod


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  if not any(a.startswith("--arch") for a in argv):
    argv = ["--arch", "tinyllama-1.1b"] + argv
  rc = serve_mod.main(argv + ["--smoke", "--batch", "4",
                              "--prompt-len", "24", "--gen", "16"])
  print("serve driver exit 0:", rc == 0)
  print(f"[checks] {int(rc == 0)} of 1 passed")
  return rc


if __name__ == "__main__":
  sys.exit(main())
