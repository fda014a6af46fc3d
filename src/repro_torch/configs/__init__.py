"""Config registry of the port: the dense, MoE, SSM, hybrid, enc-dec and
VLM architectures, the reference's whole registry.

Counterpart of ``repro/configs/__init__.py``.  Each ``<arch>.py`` exports
``CONFIG`` (the published configuration, full scale) and ``smoke_config()``
(a reduced same-family config for CPU tests and smoke training runs);
``simd2_apps`` holds the paper's own workloads (Table 4).  Every
architecture here serves and trains.  The dry run's input shapes
(``SHAPES``) and its per-architecture skip rule (``skip_reason``) live
here, as in the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_ARCHS = {  # the reference's order
    "mamba2-780m": "mamba2_780m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-8b": "granite_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "zamba2-7b": "zamba2_7b",
    "chameleon-34b": "chameleon_34b",
}




@dataclasses.dataclass(frozen=True)
class Shape:
  name: str
  seq_len: int
  global_batch: int
  kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic/bounded-state attention: run for SSM/hybrid
# and SWA archs, skip for pure full-attention archs
LONG_OK = {"mamba2-780m", "zamba2-7b", "mixtral-8x7b", "h2o-danube-1.8b"}


def skip_reason(arch: str, shape: str) -> Optional[str]:
  if shape == "long_500k" and arch not in LONG_OK:
    return "pure full-attention arch: 524k dense-KV decode is not sub-quadratic"
  return None


def list_archs():
  return list(_ARCHS)


def cells():
  """All (arch, shape) cells incl. skipped ones (with reasons)."""
  out = []
  for a in _ARCHS:
    for s in SHAPES:
      out.append((a, s, skip_reason(a, s)))
  return out


def get_config(name: str, smoke: bool = False):
  mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
  return mod.smoke_config() if smoke else mod.CONFIG
