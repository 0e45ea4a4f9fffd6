"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
- M-RoPE (t/h/w sections), dynamic resolution.  [arXiv:2409.12191]

``config()`` is ``repro``'s entry, the language backbone alone: callers
pass precomputed embeddings (B, S, d_model) and (3, B, S) M-RoPE position
ids as ``Model.forward(embeds=..., positions=...)``, or tokens, and its
layers have no q/k/v biases, so that the port's backbone is held leaf by
leaf to ``repro``'s stub.  ``whole_config()`` is the whole model of
Hugging Face's ``Qwen/Qwen2-VL-2B`` ``config.json``: the vision tower
(``models/vision.py``: a 1,176 -> 1,280 patch embedding, 32 blocks of
1,280 with 16 heads of 80 and a QuickGELU MLP of 5,120, the 2 x 2
merger to 1,536) and Qwen2's q/k/v biases; it takes tokens with image
pads, ``pixels`` and ``grids``, and computes the M-RoPE positions itself.
"""
import dataclasses

from .base import ModelConfig

# the tower, the merge and the biases of Qwen2-VL-2B's config.json
# (vision_config: depth 32, embed_dim 1280, num_heads 16, mlp_ratio 4,
# patch_size 14 x temporal_patch_size 2 x in_chans 3, spatial_merge_size
# 2; image_token_id 151655)
VISION = dict(qkv_bias=True, vision_layers=32, vision_d=1280,
              vision_heads=16, vision_ff=5120, vision_patch_dim=1176,
              vision_merge=2, image_token_id=151655)


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


def whole_config() -> ModelConfig:
    """The whole model: tower, merger and biases on the backbone."""
    return dataclasses.replace(config(), name="qwen2-vl-2b-whole",
                               embeds_input=False, **VISION)


def whole_smoke_config() -> ModelConfig:
    """``whole_config`` at the smoke backbone's size: 2 tower blocks of
    160 with 2 heads of 80 (the kernels' head dim), an MLP of 320."""
    return dataclasses.replace(
        smoke_config(), name="qwen2-vl-2b-whole-smoke", embeds_input=False,
        **dict(VISION, vision_layers=2, vision_d=160, vision_heads=2,
               vision_ff=320, image_token_id=500))
