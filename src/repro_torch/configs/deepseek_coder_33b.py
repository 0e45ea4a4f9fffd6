"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256.  [arXiv:2401.14196]"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=19200, vocab_size=32256,
        rope_theta=100000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="deepseek-coder-33b-smoke", n_layers=3, d_model=56,
        n_heads=7, n_kv_heads=1, d_ff=96, vocab_size=384, head_dim=0)
