"""LM substrate: configs, layers and the dense, MoE, SSM and hybrid
families, with the zoo API."""
from repro_torch.models.common import ModelConfig
from repro_torch.models import zoo

__all__ = ["ModelConfig", "zoo"]
