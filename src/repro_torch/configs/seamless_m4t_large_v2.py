"""seamless-m4t-large-v2 [audio] — enc-dec backbone; the audio frontend is a
STUB (input_specs provides precomputed frame embeddings).  The assignment's
"24L" is realized as 24 encoder + 24 decoder layers (the m4t-large text
enc/dec depths).  [arXiv:2308.11596; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, head_dim=64,
    enc_layers=24, dec_layers=24, cross_attention=True,
    src_len=4096, modality_stub="audio",
)


def smoke_config():
  return CONFIG.replace(n_layers=2, enc_layers=2, dec_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                        head_dim=16, src_len=24)
