from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (Model, Parallelism, build_model,
                                         param_shapes, param_specs)

__all__ = ["ModelConfig", "Model", "Parallelism", "build_model",
           "param_shapes", "param_specs"]
