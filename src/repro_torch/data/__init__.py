"""Deterministic data pipeline."""
from repro_torch.data.pipeline import (DataConfig, PackedCorpus, SyntheticLM,
                                       make_source)

__all__ = ["DataConfig", "PackedCorpus", "SyntheticLM", "make_source"]
