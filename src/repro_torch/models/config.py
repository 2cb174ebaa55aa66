"""Model configuration shared by all assigned architectures (a copy of
``repro/models/config.py``), plus :func:`torch_dtype` for ``cfg.dtype``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig", "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    mlp_kind: str = "swiglu"     # swiglu | gelu
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0             # per-expert hidden dim
    moe_capacity: float = 1.25
    moe_shared_ff: int = 0       # shared-expert hidden dim (0 = none)
    moe_dispatch: str = "sf"     # sf (star-forest routed) | dense
    # hybrid / ssm
    ssm_state: int = 0
    ssm_heads: int = 0
    attn_window: Optional[int] = None     # sliding-window size
    global_layer_every: int = 0  # hybrid: every k-th layer uses full attention
    block_kind: str = "transformer"       # transformer | hymba | xlstm
    # enc-dec (audio)
    enc_layers: int = 0
    cross_attention: bool = False
    # modality frontend (stubbed per brief: input_specs provides embeddings)
    frontend: str = "none"       # none | audio_stub | vision_stub
    # numerics
    dtype: str = "bfloat16"
    # distribution knobs (overridable per experiment — see §Perf)
    remat: str = "block"         # none | block
    seq_shard: bool = False      # sequence-parallel activations between blocks
    use_flash_kernel: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def param_count(self) -> int:
        """Total parameters N (embedding included once)."""
        D, L, V = self.d_model, self.n_layers, self.vocab
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D
        if self.qk_norm:
            attn += 2 * hd
        if self.is_moe:
            ff = self.moe_experts * (3 * D * self.moe_dff) + D * self.moe_experts
            if self.moe_shared_ff:
                ff += 3 * D * self.moe_shared_ff
        elif self.d_ff:
            nmat = 3 if self.mlp_kind == "swiglu" else 2
            ff = nmat * D * self.d_ff
        else:
            ff = 0
        if self.block_kind == "hymba":
            P = self.ssm_heads * self.hd
            ff += 2 * D * P + P * D + P * (2 * self.ssm_state + 2)
        if self.block_kind == "xlstm":
            # mlstm/slstm internal projections (approximate: q,k,v,o + gates)
            ff += 4 * D * D + 4 * D
        norms = 2 * D
        per_layer = attn + ff + norms
        if self.block_kind == "xlstm":
            per_layer = ff + norms   # no separate attention stack
        emb = V * D
        head = 0 if self.tie_embeddings else V * D
        enc = self.enc_layers * (attn + (2 if self.mlp_kind == "gelu" else 3)
                                 * D * self.d_ff + norms)
        cross = L * (D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D + D) \
            if self.cross_attention else 0
        return L * per_layer + emb + head + enc + cross + 2 * D

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        dense = self.param_count() - L * (
            self.moe_experts * 3 * D * self.moe_dff)
        act_ff = L * self.moe_topk * 3 * D * self.moe_dff
        return dense + act_ff

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke_config(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            moe_experts=4 if self.is_moe else 0,
            moe_topk=2 if self.is_moe else 0,
            moe_dff=64 if self.is_moe else 0,
            ssm_heads=2 if self.ssm_heads else 0,
            ssm_state=8 if self.ssm_state else 0,
            enc_layers=2 if self.enc_layers else 0,
            attn_window=16 if self.attn_window else None,
            name=self.name + "-smoke",
        )


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string (``"bfloat16"``,
    ``"float32"``, ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
