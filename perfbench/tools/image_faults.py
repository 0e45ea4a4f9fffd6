"""Faults planted in the program's image path (Qwen2-VL's tower, merger,
splice and M-RoPE index), each a context manager that patches the port's
modules for the time of one run, to show that the numbers deciding
``correct`` catch them: ``causal_tower`` (the tower's attention under a
causal mask), ``biases_dropped`` (the decoder's q/k/v biases and the
tower's qkv bias left out), ``positions_1d`` (plain 1-D positions in all
three M-RoPE streams), ``not_spliced`` (the merged cells computed but the
image pads' own embeddings kept), ``half_batch`` (the loss over the first
half of the rows, with their images and patches).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

import torch

from perfbench.tools.faults import patched


def _port():
    from repro_torch.kernels import ops
    from repro_torch.models import layers, transformer, vision
    return ops, layers, transformer, vision


def causal_tower():
    ops, *_ = _port()
    attention = ops.attention

    def causal(q, k, v, **kw):
        return attention(q, k, v, **dict(kw, causal=True))

    return patched(ops, "attention", causal)


@contextlib.contextmanager
def biases_dropped():
    _, layers, _, vision = _port()
    attention_block, block = layers.attention_block, vision.block

    def no_bias(cfg, p, x, **kw):
        return attention_block(dataclasses.replace(cfg, qkv_bias=False), p,
                               x, **kw)

    def no_qkv_bias(cfg, p, x, rot, segments):
        a = p["attn"]
        attn = {"qkv": a["qkv"], "qkv_b": torch.zeros_like(a["qkv_b"]),
                "proj": a["proj"], "proj_b": a["proj_b"]}
        tree = {"ln1": p["ln1"], "ln2": p["ln2"], "mlp": p["mlp"],
                "attn": attn}
        return block(cfg, tree, x, rot, segments)

    with patched(layers, "attention_block", no_bias), \
            patched(vision, "block", no_qkv_bias):
        yield


def positions_1d():
    *_, vision = _port()

    def plain(cfg, tokens, grid):
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32).expand(3, B, S)

    return patched(vision, "mrope_positions", plain)


def not_spliced():
    *_, vision = _port()
    return patched(vision, "splice", lambda cfg, x, tokens, feats: x)


def half_rows(batch: dict, image_id: int, merge: int) -> dict:
    """The first half of ``batch``'s rows, with their images (counted by
    their pads) and those images' patches."""
    h = batch["labels"].shape[0] // 2
    grid = batch["grids"].tolist()
    pads = int((batch["tokens"][:h] == image_id).sum())
    cells = list(itertools.accumulate(t * gh * gw // merge ** 2
                                      for t, gh, gw in grid))
    n = cells.index(pads) + 1 if pads else 0
    patches = sum(t * gh * gw for t, gh, gw in grid[:n])
    out = {k: v[:h] for k, v in batch.items()
           if k not in ("pixels", "grids")}
    return dict(out, pixels=batch["pixels"][:patches],
                grids=batch["grids"][:n])


def half_batch():
    _, _, transformer, _ = _port()
    loss = transformer.lm_loss

    def half(model, batch):
        cfg = model.cfg
        return loss(model, half_rows(batch, cfg.image_token_id,
                                     cfg.vision_merge))

    return patched(transformer, "lm_loss", half)


FAULTS = {"causal_tower": causal_tower, "biases_dropped": biases_dropped,
          "positions_1d": positions_1d, "not_spliced": not_spliced,
          "half_batch": half_batch}
