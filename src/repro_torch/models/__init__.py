"""repro_torch.models — model configuration and the dense decoder-only
transformer of the serving path (``config``, ``layers``, ``transformer``).
MoE, hybrid, recurrent and encoder-decoder blocks come in later slices."""

from .config import ModelConfig, torch_dtype
from . import layers, transformer

__all__ = ["ModelConfig", "torch_dtype", "layers", "transformer"]
