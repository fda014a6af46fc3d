"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab=32000, head_dim=80, window=4096, rope_theta=10000.0,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=512, head_dim=16, window=16)
