"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 - RG-LRU + local attention, pattern (R, R, A).
[arXiv:2402.19427]

Sub-quadratic (local window 2048 + recurrent state) => runs the long_500k
cell.  26 layers = 8 full (rglru, rglru, local_attn) periods + 2 tail rglru.
"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid_rglru", n_layers=26,
        d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
        block_pattern=("rglru", "rglru", "local_attn"), window=2048,
        lru_width=2560, rope_theta=10000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="recurrentgemma-2b-smoke", n_layers=5, d_model=64,
        n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=512, window=16,
        lru_width=64, head_dim=0)
