from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
