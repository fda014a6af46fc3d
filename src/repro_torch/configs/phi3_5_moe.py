"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, head_dim=128,
    n_experts=16, topk=2, capacity_factor=1.25, rope_theta=10000.0,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=512, head_dim=16, n_experts=4)
