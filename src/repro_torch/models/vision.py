"""Qwen2-VL's vision tower, its patch merger, and the M-RoPE positions of
rows that hold images.

The layers follow Hugging Face ``transformers``'
``models/qwen2_vl/modeling_qwen2_vl.py``:

- ``Qwen2VisionTransformerPretrainedModel``: a patch embedding (the
  Conv3d whose stride is its kernel, so one (patch_dim, d) matrix with no
  bias over each patch's channels x frames x pixels), then pre-LayerNorm
  blocks (eps 1e-6) of attention with a fused qkv and its bias and an
  output projection with its bias, and an MLP fc1 -> QuickGELU
  ``x sigmoid(1.702 x)`` -> fc2 with biases.  Each image attends within
  itself and with no causal mask: the step's patches are one packed
  sequence cut by the images' offsets (``cu_seqlens``), and the flash pair
  runs once a block over it with those segments (``kernels/ops.py``).
  The rotary positions are 2-D: a patch's row and column, in the
  processor's merge-window order, each over half of the head's rotary
  frequencies (theta 10,000 over head_dim / 2 = 40 dims: 20 frequencies
  for the row, 20 for the column), repeated to the head dim and rotated
  by halves;
- ``PatchMerger``: a LayerNorm of each patch, then each window of
  merge x merge patches (consecutive in that order) as one vector of
  merge^2 d, fc1 -> exact GELU -> fc2 to d_model, with biases;
- ``get_rope_index``, for images: text runs take t = h = w = their
  position; an image's merged cells take t = its offset, h = offset + row,
  w = offset + column, the offset being the position its first cell would
  have as text; the text after an image resumes at the largest position
  so far + 1.

Only images are computed (a grid's t = 1); a video grid raises.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import tracing
from ..kernels import ops
from . import layers as L

EPS = 1e-6                  # the tower's and the merger's LayerNorms
THETA = 10000.0             # the tower's rotary base

def grid_list(cfg, grids) -> list[tuple[int, int, int]]:
    """The (t, h, w) of each image, in patches, as Python ints (a host
    read where ``grids`` lives on the card)."""
    out = [tuple(int(x) for x in g) for g in grids.tolist()]
    m = cfg.vision_merge
    for t, h, w in out:
        if t != 1:
            raise ValueError(f"grid {(t, h, w)}: only images (t = 1) are "
                             f"computed, not video")
        if h % m or w % m:
            raise ValueError(f"grid {(t, h, w)}: h and w must be multiples "
                             f"of the merge {m}")
    return out


def to_device(t, device):
    """A host tensor on ``device``; to a card from pinned memory without
    blocking the host, so the step's kernels keep coming."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A card tensor copied to pinned host memory behind the stream's
    queued work, without waiting: ``get()`` waits for the copy alone."""

    def __init__(self, t):
        if t.device.type != "cuda":
            self.host, self.done = t, None
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def get(self):
        if self.done is not None:
            self.done.synchronize()
        return self.host


def offsets(grid) -> list[int]:
    """Each image's first patch in the packed sequence, and the total."""
    return [0, *itertools.accumulate(t * h * w for t, h, w in grid)]


def patch_positions(grid, merge: int) -> torch.Tensor:
    """(patches, 2) int64: each patch's row and column in its image, in
    merge-window order (each merge x merge window's patches consecutive,
    the windows row-major), as the processor flattens them."""
    rows = []
    for _, h, w in grid:
        hp = torch.arange(h)[:, None].expand(h, w)
        wp = torch.arange(w)[None, :].expand(h, w)
        order = [x.reshape(h // merge, merge, w // merge, merge)
                 .permute(0, 2, 1, 3).flatten() for x in (hp, wp)]
        rows.append(torch.stack(order, dim=-1))
    return torch.cat(rows)


def rotary(cfg, grid, device) -> L.Rotary:
    """The tower's ``Rotary`` tables, (1, patches, 1, head_dim / 2): angles
    [row x f, column x f] over the half-dim's frequencies f."""
    half = cfg.vision_d // cfg.vision_heads // 2
    freqs = 1.0 / THETA ** (
        torch.arange(0, half, 2, dtype=torch.float32, device=device) / half)
    pos = to_device(patch_positions(grid, cfg.vision_merge), device).float()
    ang = torch.cat([pos[:, :1] * freqs, pos[:, 1:] * freqs], dim=-1)
    return L.Rotary.of_angles(ang[None])


def layer_norm(x, p, eps):
    """LayerNorm over the last axis in float32, ``p`` its ``scale`` and
    ``shift``, returned in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["shift"].float(), eps)
    return y.to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _linear(x, w, b, dt):
    return x @ w.to(dt) + b.to(dt)


def block(cfg, p, x, rot, segments):
    """One tower block over the packed patches x (T, vision_d):
    x + attn(norm1(x)), then + mlp(norm2(x)); ``rot`` the tower's
    ``Rotary`` tables, ``segments`` the images' offsets on x's device."""
    with tracing.span("vision.block"):
        dt = L.cdt(cfg)
        T, d = x.shape
        H = cfg.vision_heads
        a = p["attn"]
        h = layer_norm(x, p["ln1"], EPS)
        qkv = _linear(h, a["qkv"], a["qkv_b"], dt).view(1, T, 3, H, d // H)
        q, k, v = (qkv[:, :, i] for i in range(3))
        q, k = rot(q).contiguous(), rot(k).contiguous()
        o = ops.attention(q, k, v.contiguous(), causal=False,
                          segments=segments)
        x = x + _linear(o.reshape(T, d), a["proj"], a["proj_b"], dt)
        m = p["mlp"]
        h = layer_norm(x, p["ln2"], EPS)
        h = quick_gelu(_linear(h, m["fc1"], m["fc1_b"], dt))
        return x + _linear(h, m["fc2"], m["fc2_b"], dt)


def tower(cfg, vision, pixels, grid, remat: bool):
    """The blocks' output (patches, vision_d) of ``pixels`` (patches,
    vision_patch_dim) with (t, h, w) ``grid``; each block recomputed in the
    backward under ``remat``."""
    dev = pixels.device
    cut = offsets(grid)
    if tuple(pixels.shape) != (cut[-1], cfg.vision_patch_dim):
        raise ValueError(f"pixels {tuple(pixels.shape)} do not fit grids "
                         f"{grid}: need ({cut[-1]}, {cfg.vision_patch_dim})")
    rot = rotary(cfg, grid, dev)
    segments = to_device(torch.tensor(cut, dtype=torch.int32), dev)
    dt = L.cdt(cfg)
    x = pixels.to(dt) @ vision["patch_embed"].to(dt)
    for p in vision["blocks"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x, p=p: block(cfg, p, x, rot, segments), x,
                use_reentrant=False)
        else:
            x = block(cfg, p, x, rot, segments)
    return x


def merge(cfg, p, x):
    """The merger: (patches, vision_d) -> (patches / merge^2, d_model)."""
    dt = L.cdt(cfg)
    h = layer_norm(x, p["ln"], EPS)
    h = h.reshape(-1, cfg.vision_merge ** 2 * cfg.vision_d)
    h = F.gelu(_linear(h, p["fc1"], p["fc1_b"], dt))
    return _linear(h, p["fc2"], p["fc2_b"], dt)


def splice(cfg, x, tokens, feats):
    """x (B, S, d) with the merged cells ``feats`` in the places of the
    image pads of ``tokens``, in order."""
    pads = (tokens == cfg.image_token_id)[..., None]
    return x.masked_scatter(pads, feats.to(x.dtype))


def attention_pairs(grid) -> int:
    """The tower's visible query-key pairs a block: each image's patches
    squared."""
    return sum((t * h * w) ** 2 for t, h, w in grid)


def mrope_positions(cfg, tokens, grid) -> torch.Tensor:
    """(3, B, S) int32 M-RoPE positions of ``tokens`` (B, S), whose image
    pads (``cfg.image_token_id``) take the merged cells of ``grid``'s
    images in order, row after row (``get_rope_index``).  Computed on the
    host; raises where the pads and the grids disagree."""
    tok = tokens.cpu()
    B, S = tok.shape
    m = cfg.vision_merge
    out = torch.empty(3, B, S, dtype=torch.int32)
    images = iter(grid)
    for b in range(B):
        pads = (tok[b] == cfg.image_token_id).nonzero().flatten().tolist()
        st = nxt = j = 0
        while j < len(pads):
            g = next(images, None)
            if g is None:
                raise ValueError(f"row {b} holds more image pads than the "
                                 f"grids give cells")
            gh, gw = g[1] // m, g[2] // m
            n, ed = gh * gw, pads[j]
            if j + n > len(pads) or pads[j + n - 1] != ed + n - 1:
                raise ValueError(f"row {b}: image of {gh} x {gw} cells "
                                 f"needs {n} consecutive pads from {ed}")
            out[:, b, st:ed] = nxt + torch.arange(ed - st)
            off = nxt + ed - st
            out[0, b, ed:ed + n] = off
            out[1, b, ed:ed + n] = off + torch.arange(gh).repeat_interleave(gw)
            out[2, b, ed:ed + n] = off + torch.arange(gw).repeat(gh)
            nxt, st, j = off + max(gh, gw), ed + n, j + n
        out[:, b, st:] = nxt + torch.arange(S - st)
    if next(images, None) is not None:
        raise ValueError("the grids give more images than the rows' pads")
    return out
