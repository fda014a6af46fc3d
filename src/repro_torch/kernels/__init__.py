"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:
the SIMD² semiring MMO, the fused closure fixpoint, flash attention and the
SSD intra-chunk term.

As in the reference, the package names ``semiring_mmo`` and
``flash_attention`` are the batched entry points of ``ops.py`` and shadow
the kernel modules of the same names; reach those with
``from repro_torch.kernels.semiring_mmo import ...`` or
``importlib.import_module("repro_torch.kernels.semiring_mmo")``.
"""
from repro_torch.kernels.closure_megakernel import megakernel_fixpoint
from repro_torch.kernels.ops import flash_attention, semiring_mmo

__all__ = ["flash_attention", "megakernel_fixpoint", "semiring_mmo"]
