"""repro_torch.models — model configuration and the decoder-only
transformer of the serving path, dense or MoE (``config``, ``layers``,
``moe``, ``transformer``).  Hybrid, recurrent and encoder-decoder blocks
come in later slices."""

from .config import ModelConfig, torch_dtype
from . import layers, moe, transformer

__all__ = ["ModelConfig", "torch_dtype", "layers", "moe", "transformer"]
