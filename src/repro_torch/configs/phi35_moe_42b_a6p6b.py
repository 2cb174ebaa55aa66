"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct (hf tier).
32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064,
MoE 16 experts top-2."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=32064,
    moe_experts=16,
    moe_topk=2,
    moe_dff=6400,
    rope_theta=1e4,
)
