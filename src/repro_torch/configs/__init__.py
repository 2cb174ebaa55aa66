"""Assigned-architecture configs: one module per arch, exact published
numbers; ``get_config(arch_id)`` resolves by id; ``ALL_ARCHS`` lists every
selectable --arch value; SHAPES defines the assigned input-shape set."""

from importlib import import_module

ALL_ARCHS = [
    "mistral-large-123b",
    "qwen3-4b",
    "qwen3-14b",
    "starcoder2-3b",
    "kimi-k2-1t-a32b",
    "phi3.5-moe-42b-a6.6b",
    "llava-next-34b",
    "hymba-1.5b",
    "whisper-base",
    "xlstm-350m",
]

_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-14b": "qwen3_14b",
    "starcoder2-3b": "starcoder2_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6p6b",
    "llava-next-34b": "llava_next_34b",
    "hymba-1.5b": "hymba_1p5b",
    "whisper-base": "whisper_base",
    "xlstm-350m": "xlstm_350m",
}

# Assigned LM shape set: (name, seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    dict(seq_len=4096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288, global_batch=1,   kind="decode"),
}

# long_500k requires a sub-quadratic family (DESIGN.md §4.1)
LONG_CONTEXT_ARCHS = {"hymba-1.5b", "xlstm-350m"}


def get_config(arch: str):
    mod = import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def shape_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
