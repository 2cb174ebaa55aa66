"""starcoder2-3b [dense] — arXiv:2402.19173 (hf tier).
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE,
GELU MLP."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    mlp_kind="gelu",
    rope_theta=1e5,
)
