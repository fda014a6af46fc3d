"""LM substrate: configs, layers and the dense, MoE, SSM and hybrid
families, with the zoo API and the sharding rules."""
from repro_torch.models.common import ModelConfig, Parallelism, specs_like
from repro_torch.models import zoo

__all__ = ["ModelConfig", "Parallelism", "specs_like", "zoo"]
