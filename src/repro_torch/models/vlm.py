"""Chameleon-style early-fusion VLM utilities.

Counterpart of ``repro/models/vlm.py``.  The backbone is the dense
transformer (``qk_norm=True``, as chameleon has; ``models/transformer.py``);
images enter as VQ codebook token ids fused into the text stream.  The VQ
image-tokenizer frontend is a stub, but its core computation,
nearest-codebook search, is exactly the paper's ``addnorm`` SIMD²
instruction, so ``vq_tokenize`` runs on the SIMD² path:
D[i, j] = Σ_k (patch_i[k] − code_j[k])², then the argmin over j.  On
``backend="pallas"`` that is one launch of K1's addnorm instance.
"""
from __future__ import annotations

import torch

from repro_torch.core.mmo import mmo

Tensor = torch.Tensor


def vq_tokenize(patch_embeds: Tensor, codebook: Tensor, *,
                backend: str = "auto") -> Tensor:
  """patch_embeds (..., P, D), codebook (K, D) → int32 token ids (..., P).

  ``backend`` is ``core.mmo``'s: 'pallas' the SIMD² kernel K1, 'xla' the
  matmul expansion, 'vector' the arm with no SIMD² unit, 'auto' the cost
  table's choice ('xla' without one)."""
  flat = patch_embeds.reshape(-1, patch_embeds.shape[-1])
  d2 = mmo(flat, codebook.T, op="addnorm", backend=backend)
  ids = torch.argmin(d2, dim=-1).to(torch.int32)
  return ids.reshape(patch_embeds.shape[:-1])


def fuse_streams(text_tokens: Tensor, image_tokens: Tensor,
                 image_token_offset: int) -> Tensor:
  """Early fusion: image token ids are shifted into their reserved vocab
  range and put ahead of the text tokens."""
  return torch.cat([image_tokens + image_token_offset, text_tokens], dim=-1)
