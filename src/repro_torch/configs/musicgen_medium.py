"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048
- decoder-only over EnCodec tokens.  [arXiv:2306.05284]

Backbone only: the EnCodec frontend (4-codebook delay pattern, token
embedding, sinusoidal positions) is a STUB - callers pass precomputed frame
embeddings (B, S, d_model) as ``Model.forward(embeds=...)``; the head
predicts one codebook stream (vocab 2048).  Copy of ``repro``'s config.
"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="dense", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
        pos_type="none", embeds_input=True, mlp_variant="gelu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="musicgen-medium-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128, head_dim=0)
