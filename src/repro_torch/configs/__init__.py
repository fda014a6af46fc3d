"""Config registry of the port: the dense, MoE, SSM and hybrid LM
architectures.

Counterpart of ``repro/configs/__init__.py``.  Each ``<arch>.py`` exports
``CONFIG`` (the published configuration, full scale) and ``smoke_config()``
(a reduced same-family config for CPU tests and smoke training runs);
``simd2_apps`` holds the paper's own workloads (Table 4).  Every
architecture here serves and trains.  The other families of the
reference's registry (enc-dec, VLM) are ROADMAP item 13's step 4.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-8b": "granite_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mamba2-780m": "mamba2_780m",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "zamba2-7b": "zamba2_7b",
}
# the reference's other architectures, not ported yet
_LATER = ("seamless-m4t-large-v2", "chameleon-34b")


def list_archs():
  return list(_ARCHS)


def get_config(name: str, smoke: bool = False):
  if name in _LATER:
    raise NotImplementedError(
        f"{name}: the port has the dense, MoE, SSM and hybrid LM families; "
        f"enc-dec and VLM are ROADMAP item 13")
  mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
  return mod.smoke_config() if smoke else mod.CONFIG
