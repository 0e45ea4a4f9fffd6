"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
- M-RoPE (t/h/w sections), dynamic resolution.  [arXiv:2409.12191]

Backbone only: the vision tower is a STUB - callers pass precomputed
patch+text embeddings (B, S, d_model) and (3, B, S) M-RoPE position ids as
``Model.forward(embeds=..., positions=...)``.  Copy of ``repro``'s config.
"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
        pos_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1000000.0,
        embeds_input=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen2-vl-2b-smoke", n_layers=2, d_model=96,
        n_heads=3, n_kv_heads=1, d_ff=192, vocab_size=512, head_dim=0,
        mrope_sections=(8, 4, 4))
