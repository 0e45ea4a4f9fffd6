"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
[arXiv:2403.04652]"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000,
        rope_theta=5000000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="yi-34b-smoke", n_layers=2, d_model=56, n_heads=7,
        n_kv_heads=1, d_ff=112, vocab_size=256, head_dim=0)
