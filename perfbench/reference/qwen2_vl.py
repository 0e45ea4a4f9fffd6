"""Plain float32 reference of Qwen2-VL (Qwen2VLForConditionalGeneration),
its training step on image rows, and the reader of its configuration
file.

It follows the configuration file and Hugging Face ``transformers``'
``models/qwen2_vl/modeling_qwen2_vl.py``: the vision tower
(``Qwen2VisionTransformerPretrainedModel``: the patch embedding, pre-
LayerNorm blocks with a fused qkv and its bias, 2-D rotary positions over
each patch's row and column, a QuickGELU MLP; every image attending
within itself, no causal mask), the 2 x 2 ``PatchMerger`` (LayerNorm, fc1,
exact GELU, fc2), the merged cells spliced at the image pads, the M-RoPE
index of ``get_rope_index`` (found from the vision-start tokens, as that
function finds images), and the Qwen2 decoder (RMS norms, q/k/v biases,
M-RoPE by ``mrope_section``, SwiGLU, the unembedding tied to the
embedding table).  The loss is next-token cross-entropy plus a 1e-4
z-loss, the mean over the positions of the batch's ``mask``.  It imports
nothing of the program under test: its index, segment mask and rotary
tables are its own.  Every weight product runs through ``mm`` (float32 by
default, TF32 off); the control passes a lower precision there.  Rows are
taken ``row_chunk`` at a time with their images, each layer and tower
block recomputed in the backward, and attention scores cut into blocks of
heads, so that the whole model trains on one card after the program has
been freed.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from perfbench.harness import yardstick
from perfbench.reference import dense
from perfbench.reference.leaves import Group, Leaf

SCORE_BLOCK = 1 << 28           # elements of one block of attention scores
V_EPS = 1e-6                    # the tower's and the merger's LayerNorms
V_THETA = 10000.0               # VisionRotaryEmbedding's base
highest_precision = dense.highest_precision
matmul = dense.matmul


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of a Qwen2-VL configuration, read under the source's own
    key names (``config.json``, its ``vision_config`` nested)."""
    d: int                  # hidden size
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    eps: float              # RMS norm epsilon
    theta: float
    sections: tuple         # mrope_section: t, h, w frequencies
    init_std: float
    vd: int                 # the tower's width (embed_dim)
    v_layers: int
    v_heads: int
    v_ff: int
    patch_dim: int          # in_chans x temporal_patch_size x patch_size^2
    merge: int
    image_id: int
    start_id: int           # <|vision_start|>
    end_id: int             # <|vision_end|>
    compute_dtype: str
    param_dtype: str

    tied = True

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def v_head_dim(self) -> int:
        return self.vd // self.v_heads

    @property
    def merged(self) -> int:
        return self.merge ** 2 * self.vd

    @classmethod
    def from_file(cls, c: dict) -> "Dims":
        """Refuses what this reference does not compute: another
        activation, an untied head, rotary positions other than M-RoPE,
        a tower that takes video frames one at a time."""
        v = c["vision_config"]
        if c["hidden_act"] != "silu":
            raise ValueError(f"activation {c['hidden_act']!r}: this "
                             f"reference computes SwiGLU only")
        if v.get("hidden_act", "quick_gelu") != "quick_gelu":
            raise ValueError(f"tower activation {v['hidden_act']!r}: this "
                             f"reference computes QuickGELU only")
        if not c["tie_word_embeddings"]:
            raise ValueError("an untied head: this reference ties it")
        rope = c.get("rope_scaling") or {}
        if rope.get("type", rope.get("rope_type")) != "mrope":
            raise ValueError(f"rotary positions {rope!r}: M-RoPE only")
        if c.get("video"):
            raise ValueError("video: this reference computes images only")
        d, heads = c["hidden_size"], c["num_attention_heads"]
        run = c["run"]
        return cls(
            d=d, layers=c["num_hidden_layers"], heads=heads,
            kv_heads=c["num_key_value_heads"], head_dim=d // heads,
            ff=c["intermediate_size"], vocab=c["vocab_size"],
            eps=float(c["rms_norm_eps"]), theta=float(c["rope_theta"]),
            sections=tuple(rope["mrope_section"]),
            init_std=float(c["initializer_range"]),
            vd=v["embed_dim"], v_layers=v["depth"], v_heads=v["num_heads"],
            v_ff=v["embed_dim"] * v["mlp_ratio"],
            patch_dim=(v["in_chans"] * v["temporal_patch_size"]
                       * v["patch_size"] ** 2),
            merge=v["spatial_merge_size"],
            image_id=c["image_token_id"],
            start_id=c["vision_start_token_id"],
            end_id=c["vision_end_token_id"],
            compute_dtype=run["compute_dtype"],
            param_dtype=run["param_dtype"])

    def layer_matrices(self) -> list[tuple[str, tuple[int, int]]]:
        d, f = self.d, self.ff
        return [("attn.wq", (d, self.q_dim)), ("attn.wk", (d, self.kv_dim)),
                ("attn.wv", (d, self.kv_dim)), ("attn.wo", (self.q_dim, d)),
                ("mlp.gate", (d, f)), ("mlp.up", (d, f)),
                ("mlp.down", (f, d))]

    def block_matrices(self) -> list[tuple[str, tuple[int, int]]]:
        vd, f = self.vd, self.v_ff
        return [("attn.qkv", (vd, 3 * vd)), ("attn.proj", (vd, vd)),
                ("mlp.fc1", (vd, f)), ("mlp.fc2", (f, vd))]

    def merger_matrices(self) -> list[tuple[str, tuple[int, int]]]:
        return [("fc1", (self.merged, self.merged)),
                ("fc2", (self.merged, self.d))]

    def groups(self) -> list[Group]:
        """Every leaf of the program's tree, in draw groups: the embedding
        table, the final norm's scale, each decoder layer, the patch
        embedding, each tower block and the merger.  Norm scales are
        ones; every matrix, bias and LayerNorm shift is normals of std
        ``init_std``, so that a program that drops a bias or a shift
        fails the gradient check."""
        std, d, vd = self.init_std, self.d, self.vd
        out = [Group(("embed",), "", (Leaf("embed", (self.vocab, d), std),)),
               Group(("final_norm",), "", (Leaf("final_norm", (d,), None),))]
        layer = (Leaf("ln1.scale", (d,), None), Leaf("ln2.scale", (d,), None),
                 *(Leaf(n, s, std) for n, s in self.layer_matrices()),
                 Leaf("attn.bq", (self.q_dim,), std),
                 Leaf("attn.bk", (self.kv_dim,), std),
                 Leaf("attn.bv", (self.kv_dim,), std))
        out += [Group(("layer", i), f"layers.{i}.", layer)
                for i in range(self.layers)]
        out.append(Group(("patch",), "vision.", (
            Leaf("patch_embed", (self.patch_dim, vd), std),)))
        block = (Leaf("ln1.scale", (vd,), None), Leaf("ln1.shift", (vd,), std),
                 Leaf("ln2.scale", (vd,), None), Leaf("ln2.shift", (vd,), std),
                 *(Leaf(n, s, std) for n, s in self.block_matrices()),
                 Leaf("attn.qkv_b", (3 * vd,), std),
                 Leaf("attn.proj_b", (vd,), std),
                 Leaf("mlp.fc1_b", (self.v_ff,), std),
                 Leaf("mlp.fc2_b", (vd,), std))
        out += [Group(("vision_block", j), f"vision.blocks.{j}.", block)
                for j in range(self.v_layers)]
        out.append(Group(("merger",), "merger.", (
            Leaf("ln.scale", (vd,), None), Leaf("ln.shift", (vd,), std),
            *(Leaf(n, s, std) for n, s in self.merger_matrices()),
            Leaf("fc1_b", (self.merged,), std), Leaf("fc2_b", (d,), std))))
        return out

    def token_matmul_params(self) -> int:
        """Weights of every product an LM position runs through: each
        layer's matrices and the unembedding (biases not counted)."""
        layer = sum(a * b for _, (a, b) in self.layer_matrices())
        return self.layers * layer + self.d * self.vocab

    def patch_matmul_params(self) -> int:
        """Weights of every product a patch runs through: the patch
        embedding and each block's matrices."""
        block = sum(a * b for _, (a, b) in self.block_matrices())
        return self.patch_dim * self.vd + self.v_layers * block

    def cell_matmul_params(self) -> int:
        """Weights of the merger's products, which a merged cell runs."""
        return sum(a * b for _, (a, b) in self.merger_matrices())

    @property
    def attention_layers(self) -> int:
        return self.layers


def train_batch_flops(dm: Dims, feed, i: int) -> float:
    """Training batch ``i``'s model FLOPs, from the feed's host-side grids:
    the decoder's dense count over B rows of S (6 N a position, 12 D a
    causal pair, each head and layer), 6 N a patch through the tower and
    12 D a visible pair (every patch pair of an image, no causal mask)
    each tower head and block, and the merger's 6 N a merged cell."""
    grid = feed.grids(i)
    patches = [t * h * w for t, h, w in grid]
    tower = (6 * dm.patch_matmul_params() * sum(patches)
             + 12 * dm.v_head_dim * dm.v_heads * dm.v_layers
             * yardstick.segment_pairs(patches, causal=False))
    merger = 6 * dm.cell_matmul_params() * sum(patches) // dm.merge ** 2
    return yardstick.train_step_flops(dm, feed.B, feed.S) + tower + merger


def program_fields(dm: Dims, c: dict) -> dict:
    """The fields of the program's ``ModelConfig`` that the file fixes:
    the Qwen2 decoder with q/k/v biases and M-RoPE, the vision tower, the
    merge and the image pad's id."""
    run = c["run"]
    return {"family": "dense", "block_pattern": ("attn",),
            "n_layers": dm.layers, "d_model": dm.d, "n_heads": dm.heads,
            "n_kv_heads": dm.kv_heads, "head_dim": dm.head_dim,
            "d_ff": dm.ff, "vocab_size": dm.vocab, "norm_eps": dm.eps,
            "mlp_variant": "swiglu", "pos_type": "mrope",
            "mrope_sections": dm.sections, "rope_theta": dm.theta,
            "tie_embeddings": True, "embeds_input": False, "window": 0,
            "qkv_bias": True, "vision_layers": dm.v_layers,
            "vision_d": dm.vd, "vision_heads": dm.v_heads,
            "vision_ff": dm.v_ff, "vision_patch_dim": dm.patch_dim,
            "vision_merge": dm.merge, "image_token_id": dm.image_id,
            "compute_dtype": dm.compute_dtype,
            "param_dtype": dm.param_dtype, "remat": bool(run["remat"])}


def serve_logits(*args, **kwargs):
    raise NotImplementedError("qwen2-vl-2b has no serving cell: image "
                              "serving is not measured")


# -- the model ----------------------------------------------------------------

def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _group_params(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def layer_norm(x, scale, shift, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + shift


def masked_attention(q, k, v, visible):
    """Softmax attention of q (T, H, D) over k, v (T, H, D), query i
    seeing key j where ``visible[i, j]``; heads taken a block at a
    time."""
    T, H, D = q.shape
    step = max(1, SCORE_BLOCK // (T * T))
    outs = []
    for a in range(0, H, step):
        qs, ks, vs = (x[:, a:a + step].transpose(0, 1) for x in (q, k, v))
        s = (qs @ ks.transpose(-1, -2)) * D ** -0.5
        p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
        outs.append((p @ vs).transpose(0, 1))
    return torch.cat(outs, dim=1)


def vision_cos_sin(dm: Dims, grid, device):
    """cos and sin (patches, head_dim) of the tower's rotary positions:
    ``rot_pos_emb``'s row and column ids in merge-window order, each over
    head_dim / 4 frequencies of theta over head_dim / 2, concatenated and
    repeated to the head dim; worked out in float64."""
    half = dm.v_head_dim // 2
    inv = 1.0 / V_THETA ** (torch.arange(0, half, 2, dtype=torch.float64,
                                            device=device) / half)
    ids = []
    for t, h, w in grid:
        hpos = torch.arange(h).unsqueeze(1).expand(-1, w)
        wpos = torch.arange(w).unsqueeze(0).expand(h, -1)
        m = dm.merge
        hpos = hpos.reshape(h // m, m, w // m, m).permute(0, 2, 1, 3)
        wpos = wpos.reshape(h // m, m, w // m, m).permute(0, 2, 1, 3)
        ids.append(torch.stack([hpos.flatten(), wpos.flatten()], -1)
                   .repeat(t, 1))
    ids = torch.cat(ids).to(device)
    full = torch.arange(int(ids.max()) + 1, dtype=torch.float64,
                        device=device)[:, None] * inv
    emb = full[ids].flatten(1)                          # (patches, half)
    ang = torch.cat([emb, emb], dim=-1)
    return ang.cos().float(), ang.sin().float()


def vision_block(dm: Dims, p: dict, x, cos, sin, visible, mm=matmul):
    T = x.shape[0]
    H, D = dm.v_heads, dm.v_head_dim
    h = layer_norm(x, p["ln1.scale"], p["ln1.shift"], V_EPS)
    qkv = (mm(h, p["attn.qkv"]) + p["attn.qkv_b"]).view(T, 3, H, D)
    q, k, v = qkv.unbind(1)
    c, s = cos[:, None], sin[:, None]
    q = q * c + _rotate_half(q) * s
    k = k * c + _rotate_half(k) * s
    o = masked_attention(q, k, v, visible).reshape(T, dm.vd)
    x = x + mm(o, p["attn.proj"]) + p["attn.proj_b"]
    h = layer_norm(x, p["ln2.scale"], p["ln2.shift"], V_EPS)
    h = mm(h, p["mlp.fc1"]) + p["mlp.fc1_b"]
    h = h * torch.sigmoid(1.702 * h)
    return x + mm(h, p["mlp.fc2"]) + p["mlp.fc2_b"]


def image_features(dm: Dims, params: dict, pixels, grid, mm=matmul,
                   remat=False):
    """The merged cells (cells, d) of ``pixels`` (patches, patch_dim) with
    (t, h, w) ``grid``: the tower, each image attending within itself, and
    the merger."""
    dev = pixels.device
    sizes = [t * h * w for t, h, w in grid]
    image = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                    torch.tensor(sizes, device=dev))
    visible = image[:, None] == image[None, :]
    cos, sin = vision_cos_sin(dm, grid, dev)
    x = mm(pixels, params["vision.patch_embed"])
    for j in range(dm.v_layers):
        p = _group_params(params, f"vision.blocks.{j}.")
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                vision_block, dm, p, x, cos, sin, visible, mm,
                use_reentrant=False)
        else:
            x = vision_block(dm, p, x, cos, sin, visible, mm)
    p = _group_params(params, "merger.")
    h = layer_norm(x, p["ln.scale"], p["ln.shift"], V_EPS)
    h = mm(h.reshape(-1, dm.merged), p["fc1"]) + p["fc1_b"]
    return mm(F.gelu(h), p["fc2"]) + p["fc2_b"]


def rope_index(dm: Dims, tokens, grid):
    """(3, B, S) positions of ``get_rope_index`` for image rows: each
    image found at a vision-start token, its grid taken in order."""
    out = torch.zeros(3, *tokens.shape, dtype=torch.long)
    images = iter(grid)
    for b, row in enumerate(tokens.tolist()):
        parts, st = [], 0
        for _ in range(row_images(dm, [row])[0]):
            ed = row.index(dm.image_id, st)
            t, h, w = next(images)
            gt, gh, gw = t, h // dm.merge, w // dm.merge
            st_idx = int(parts[-1].max()) + 1 if parts else 0
            parts.append(torch.arange(ed - st).expand(3, -1) + st_idx)
            ti = torch.arange(gt).view(-1, 1).expand(-1, gh * gw).flatten()
            hi = torch.arange(gh).view(1, -1, 1).expand(gt, -1, gw).flatten()
            wi = torch.arange(gw).view(1, 1, -1).expand(gt, gh, -1).flatten()
            parts.append(torch.stack([ti, hi, wi]) + ed - st + st_idx)
            st = ed + gt * gh * gw
        if st < len(row):
            st_idx = int(parts[-1].max()) + 1 if parts else 0
            parts.append(torch.arange(len(row) - st).expand(3, -1) + st_idx)
        out[:, b] = torch.cat(parts, dim=1)
    return out


def mrope_cos_sin(dm: Dims, positions):
    """cos and sin (B, S, head_dim) of (3, B, S) positions: each stream's
    angles over ``cat(freqs, freqs)``, then each section of the
    mrope_section (twice over) taken from its stream, as
    ``apply_multimodal_rotary_pos_emb`` selects them; in float64."""
    D = dm.head_dim
    inv = 1.0 / dm.theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                          device=positions.device) / D)
    f = positions.double()[..., None] * inv             # (3, B, S, D/2)
    ang = torch.cat([f, f], dim=-1)
    parts = ang.split(list(dm.sections) * 2, dim=-1)
    ang = torch.cat([part[i % 3] for i, part in enumerate(parts)], dim=-1)
    return ang.cos().float(), ang.sin().float()


def layer(dm: Dims, p: dict, x, cos, sin, mm=matmul):
    """One decoder layer of x (B, S, d) under M-RoPE tables (B, S, D);
    causal GQA attention with q/k/v biases."""
    B, S, _ = x.shape
    h = dense.rms_norm(x, p["ln1.scale"], dm.eps)
    q = (mm(h, p["attn.wq"]) + p["attn.bq"]).view(B, S, dm.heads, -1)
    k = (mm(h, p["attn.wk"]) + p["attn.bk"]).view(B, S, dm.kv_heads, -1)
    v = (mm(h, p["attn.wv"]) + p["attn.bv"]).view(B, S, dm.kv_heads, -1)
    c, s = cos[:, :, None], sin[:, :, None]
    q = q * c + _rotate_half(q) * s
    k = k * c + _rotate_half(k) * s
    x = x + mm(dense.attention(q, k, v).reshape(B, S, dm.q_dim),
               p["attn.wo"])
    h = dense.rms_norm(x, p["ln2.scale"], dm.eps)
    m = F.silu(mm(h, p["mlp.gate"])) * mm(h, p["mlp.up"])
    return x + mm(m, p["mlp.down"])


def row_images(dm: Dims, rows) -> list[int]:
    """The number of images of each row (lists of ids): its vision-start
    tokens followed by an image pad."""
    return [sum(1 for i, t in enumerate(row[:-1])
                if t == dm.start_id and row[i + 1] == dm.image_id)
            for row in rows]


def logits(dm: Dims, params: dict, tokens, pixels, grid, mm=matmul,
           remat=False):
    """The logits (B, S, vocab) of ``tokens`` (B, S) with ``pixels`` and
    the (t, h, w) ``grid`` of their images."""
    x = params["embed"][tokens.long()]
    if grid:
        feats = image_features(dm, params, pixels, grid, mm, remat)
        pads = tokens == dm.image_id
        if int(pads.sum()) != feats.shape[0]:
            raise ValueError(f"{int(pads.sum())} image pads for "
                             f"{feats.shape[0]} merged cells")
        x = x.masked_scatter(pads[..., None], feats)
    cos, sin = mrope_cos_sin(dm, rope_index(dm, tokens.cpu(), grid)
                             .to(x.device))
    for i in range(dm.layers):
        p = dense.layer_params(params, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer, dm, p, x, cos, sin, mm, use_reentrant=False)
        else:
            x = layer(dm, p, x, cos, sin, mm)
    h = dense.rms_norm(x, params["final_norm"], dm.eps)
    return mm(h, params["embed"].T)


# -- training -----------------------------------------------------------------

def loss_and_grads(dm: Dims, params: dict, batch: dict, row_chunk: int,
                   mm=matmul):
    """The loss over the positions of ``batch["mask"]`` (the mean
    next-token cross-entropy plus 1e-4 the mean squared logz) and the
    gradient of each leaf, taken ``row_chunk`` rows (and their images) at
    a time."""
    for p in params.values():
        p.grad = None
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch["mask"].float()
    grid = [tuple(int(x) for x in g) for g in batch["grids"].tolist()]
    per_row = row_images(dm, tokens.tolist())
    first = [0, *itertools.accumulate(per_row)]
    cut = [0, *itertools.accumulate(t * h * w for t, h, w in grid)]
    B = labels.shape[0]
    n = mask.sum().clamp(min=1.0)
    total = 0.0
    for a in range(0, B, row_chunk):
        b = min(B, a + row_chunk)
        g = grid[first[a]:first[b]]
        px = batch["pixels"][cut[first[a]]:cut[first[b]]]
        z = logits(dm, params, tokens[a:b], px, g, mm, remat=True)
        logz = torch.logsumexp(z, dim=-1)
        gold = z.gather(-1, labels[a:b, :, None].long())[..., 0]
        m = mask[a:b]
        part = (((logz - gold) * m).sum() + 1e-4 * (logz * m).pow(2).sum()) / n
        part.backward()
        total += float(part.detach())
        del z, logz, gold, part
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in params.items()}
    return total, grads


def train(dm: Dims, params: dict, batch_of, tc: dict, steps: int,
          row_chunk: int, start_leaves, mm=matmul):
    """``steps`` AdamW updates of ``params`` (name -> float32 leaf,
    changed in place) on ``batch_of(i)``, as ``dense.train`` makes them
    (global-norm clip, warm-up and cosine, decoupled weight decay).
    Returns each step's loss, each leaf's gradient norm at the first step
    and each leaf's change against ``start_leaves()``."""
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    b1, b2, eps = tc["beta1"], tc["beta2"], tc["eps"]
    losses, grad_norms = [], None
    for t in range(1, steps + 1):
        loss, grads = loss_and_grads(dm, params, batch_of(t - 1), row_chunk,
                                     mm)
        losses.append(loss)
        norms = {k: float(g.double().norm()) for k, g in grads.items()}
        if grad_norms is None:
            grad_norms = norms
        gnorm = sum(x * x for x in norms.values()) ** 0.5
        scale = min(1.0, tc["grad_clip"] / max(gnorm, 1e-9))
        lr = dense.lr_at(t, tc)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k].mul_(scale)
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v[k] / (1 - b2 ** t)
                p.sub_(lr * (mhat / (vhat.sqrt() + eps)
                             + tc["weight_decay"] * p))
                p.grad = None
        del grads
    del m, v
    change = {k: float((params[k].detach() - t).double().norm())
              for k, t in start_leaves()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
