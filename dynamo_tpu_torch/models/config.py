"""Model architecture configs for the dense Llama path.

The port's own copy of the fields of dynamo_tpu/models/config.py that the
dense GQA forward reads, with the same names and defaults, so a config
built here and one built there describe the same model.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 512
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    ffn_dim: int = 128
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # explicit head_dim when it differs from dim // n_heads
    head_dim_override: int = 0
    # RoPE long-context scaling (HF rope_scaling): "none" | "llama3"
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_orig_max_seq: int = 0  # original_max_position_embeddings
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or (self.dim // self.n_heads)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


PRESETS: Dict[str, ModelConfig] = {
    # test-size model (CPU CI)
    "tiny": ModelConfig(),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        vocab_size=128256,
        dim=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=8192,
        max_seq_len=131072,
        rope_theta=500000.0,
        tie_embeddings=True,
        rope_scaling="llama3", rope_factor=32.0, rope_orig_max_seq=8192,
    ),
    # the port's first full-width model: head_dim 128, 24 query heads over
    # 8 KV heads (G = 3), ~6.4 GB in bf16
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b",
        vocab_size=128256,
        dim=3072,
        n_layers=28,
        n_heads=24,
        n_kv_heads=8,
        ffn_dim=8192,
        max_seq_len=131072,
        rope_theta=500000.0,
        tie_embeddings=True,
        rope_scaling="llama3", rope_factor=32.0, rope_orig_max_seq=8192,
    ),
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
        vocab_size=128256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14336,
        max_seq_len=131072,
        rope_scaling="llama3", rope_factor=8.0, rope_orig_max_seq=8192,
    ),
}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model config {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
