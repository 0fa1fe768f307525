"""Model configuration for the LLaMA family (port of
kvquant_tpu/models/config.py; same fields, same presets)."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32  # < n_heads => GQA
    d_head: int = 128
    d_ff: int = 11008
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: float = 1.0  # linear position scaling factor (>1 for long ctx)
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    sliding_window: int | None = None  # Mistral-style local attention
    norm_type: str = "rms"  # "rms" (LLaMA) or "layernorm" (DBRX, bias-free)

    @property
    def kv_hidden(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def scaled(self, max_seq_len: int) -> "ModelConfig":
        """Linear RoPE scaling for contexts beyond the pretraining window."""
        factor = max(1.0, max_seq_len / self.max_seq_len)
        return replace(self, rope_scaling=self.rope_scaling * factor,
                       max_seq_len=max_seq_len)


LLAMA2_7B = ModelConfig()

MISTRAL_7B = ModelConfig(
    vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=14336, rope_theta=10000.0, max_seq_len=32768,
    sliding_window=4096,
)

# small configs for tests (CPU-friendly)
TINY_LLAMA = ModelConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, max_seq_len=256,
)
TINY_GQA = ModelConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=8, n_kv_heads=2,
    d_head=8, d_ff=128, max_seq_len=256,
)
