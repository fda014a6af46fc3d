"""chameleon-34b [vlm] — early-fusion, VQ image tokens in a reserved vocab
range, qk-norm.  The image tokenizer frontend is a STUB; its nearest-codebook
search is the SIMD² addnorm op (models/vlm.py).  [arXiv:2405.09818]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, head_dim=128, qk_norm=True, rope_theta=10000.0,
)


def smoke_config():
  return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=512, head_dim=16)
