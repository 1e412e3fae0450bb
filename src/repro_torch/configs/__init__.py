"""Language-model configurations of the RAG path (the port's own copies)."""

from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

__all__ = ["LMConfig", "MLAConfig", "MoEConfig"]
