"""mamba2-780m [ssm] — SSD, attention-free.  [arXiv:2405.21060]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_chunk=256, conv_kernel=4,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, vocab=512, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=8)
