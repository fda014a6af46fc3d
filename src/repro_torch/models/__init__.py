"""LM substrate: configs, layers and the dense and SSM families, with the zoo
API."""
from repro_torch.models.common import ModelConfig
from repro_torch.models import zoo

__all__ = ["ModelConfig", "zoo"]
