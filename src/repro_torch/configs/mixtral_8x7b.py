"""mixtral-8x7b [moe] — 8 experts top-2, SWA.  [arXiv:2401.04088; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, window=4096,
    n_experts=8, topk=2, capacity_factor=1.25, rope_theta=1000000.0,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=512, head_dim=16, n_experts=4,
                        window=16)
