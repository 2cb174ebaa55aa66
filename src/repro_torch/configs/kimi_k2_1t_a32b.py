"""kimi-k2-1t-a32b [moe] — Kimi K2 trillion-param MoE, paper-table
(arXiv:2501.kimi2, unverified tier).
61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 + 1 shared expert."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=0,
    vocab=163840,
    moe_experts=384,
    moe_topk=8,
    moe_dff=2048,
    moe_shared_ff=2048,
    rope_theta=5e6,
)
