"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6.  [hf:moonshotai/Moonlight-16B-A3B]"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840,
        n_experts=64, top_k=6, rope_theta=50000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="moonshot-v1-16b-a3b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=512, n_experts=8,
        top_k=2, head_dim=0)
