"""zamba2-7b [hybrid] — Mamba2 blocks + one shared attention block applied
every 6 SSM blocks.  [arXiv:2411.15242]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_chunk=256, conv_kernel=4, hybrid_attn_every=6,
)


def smoke_config():
  return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=512, head_dim=16, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=8, hybrid_attn_every=2)
