"""granite-8b [dense] — llama-arch, code.  [arXiv:2405.04324; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, head_dim=128, rope_theta=10000.0,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=512, head_dim=16)
