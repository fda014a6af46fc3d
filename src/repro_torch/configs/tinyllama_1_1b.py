"""tinyllama-1.1b [dense] — llama2-arch small.  [arXiv:2401.02385; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32000, head_dim=64, rope_theta=10000.0,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=512, head_dim=16)
