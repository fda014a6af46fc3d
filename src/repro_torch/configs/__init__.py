"""Config registry of the port: the dense, MoE, SSM, hybrid, enc-dec and
VLM architectures, the reference's whole registry.

Counterpart of ``repro/configs/__init__.py``.  Each ``<arch>.py`` exports
``CONFIG`` (the published configuration, full scale) and ``smoke_config()``
(a reduced same-family config for CPU tests and smoke training runs);
``simd2_apps`` holds the paper's own workloads (Table 4).  Every
architecture here serves and trains.
"""
from __future__ import annotations

import importlib

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


def list_archs():
  return list(_ARCHS)


def get_config(name: str, smoke: bool = False):
  mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
  return mod.smoke_config() if smoke else mod.CONFIG
