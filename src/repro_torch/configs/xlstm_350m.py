"""xlstm-350m [ssm] — arXiv:2405.04517 (unverified tier).
24L d_model=1024 4H d_ff=0 vocab=50304 — alternating sLSTM + mLSTM blocks
(12 pairs); pure recurrence -> O(1) decode state, long_500k capable."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    block_kind="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    tie_embeddings=True,
)
