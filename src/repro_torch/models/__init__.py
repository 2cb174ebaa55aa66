"""repro_torch.models — model configuration and the model families
(``config``, ``layers``, ``moe``, ``ssm``, ``xlstm``, ``transformer``),
and the sharding spec rules (``sharding``)."""

from .config import ModelConfig, torch_dtype
from . import layers, moe, sharding, transformer

__all__ = ["ModelConfig", "torch_dtype", "layers", "moe", "sharding",
           "transformer"]
