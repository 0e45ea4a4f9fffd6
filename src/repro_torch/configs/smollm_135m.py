"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M]"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, d_ff=1536, vocab_size=49152,
        rope_theta=10000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="smollm-135m-smoke", n_layers=3, d_model=48,
        n_heads=3, n_kv_heads=3, d_ff=96, vocab_size=384, head_dim=0)
