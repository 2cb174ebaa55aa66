"""llava-next-34b [vlm] — hf:llava-hf family (unverified tier).
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — anyres tiling
frontend STUBBED per brief: input_specs() supplies precomputed patch+token
embeddings; the transformer backbone below is the graded component."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    frontend="vision_stub",
    rope_theta=5e6,
)
