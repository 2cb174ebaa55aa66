"""whisper-base [audio] — arXiv:2212.04356 (unverified tier).
6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865 — enc-dec with conv
frontend STUBBED per brief: input_specs() supplies precomputed mel-frame
embeddings (B, S_enc, 512).  MHA (kv=8 == heads)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    enc_layers=6,
    cross_attention=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    mlp_kind="gelu",
    frontend="audio_stub",
)
