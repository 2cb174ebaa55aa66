"""hymba-1.5b [hybrid] — arXiv:2411.13676 (hf tier).
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + mamba heads per block; sliding-window attention with
periodic global layers (the paper's hybrid-head + mixed-window design),
which bounds decode KV memory and makes long_500k feasible."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    block_kind="hymba",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_heads=25,
    attn_window=2048,
    global_layer_every=8,
    rope_theta=1e4,
)
