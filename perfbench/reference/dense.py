"""Plain float32 reference of a dense decoder (Llama-style attention + MLP
blocks), its training step and its serving logits, and the reader of a
dense configuration file.

A configuration file names its reference module (``"reference":
"dense"``); the harness finds this file by that name and asks it for the
sizes (``Dims.from_file``), for the fields of the program's configuration
that the file fixes (``program_fields``), for each layer's matrices (the
weights the benchmark draws) and for the reference's answers.

It follows the configuration file and the published descriptions:
pre-norm RMS norm blocks, causal GQA attention with no bias, rotary
positions (``rotate_half`` over ``cat(freqs, freqs)``, as Llama's and
Yi's modelling code rotates), a SwiGLU MLP, an untied or tied
unembedding; next-token cross-entropy with a 1e-4 z-loss; AdamW with
global-norm clipping under a linear warm-up and a cosine.  It imports
nothing of the program under test.  Every product runs through ``mm``
(float32 by default, TF32 off); the control passes a lower precision
there.  Weights come in one layer at a time (``layer_of(i)``) and work is
cut into blocks of rows and of heads, so that a full-size model fits on
one card after the program has been freed.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

SCORE_BLOCK = 1 << 28           # elements of one block of attention scores


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of a dense configuration, read under the source's own
    key names (Hugging Face's ``LlamaForCausalLM`` spelling)."""
    d: int                  # hidden size
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int                 # MLP width
    vocab: int
    eps: float              # RMS norm epsilon
    tied: bool              # unembedding against the embedding table
    theta: float
    init_std: float         # std of every weight matrix
    compute_dtype: str
    param_dtype: str

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @classmethod
    def from_file(cls, c: dict) -> "Dims":
        """Refuses what this reference does not compute: another
        activation, biases, scaled rotary positions."""
        if c["hidden_act"] != "silu":
            raise ValueError(f"activation {c['hidden_act']!r}: this "
                             f"reference computes SwiGLU only")
        if c.get("attention_bias") or c.get("mlp_bias"):
            raise ValueError("biases: this reference has none")
        if c.get("rope_scaling"):
            raise ValueError("scaled rotary positions: not computed here")
        d, heads = c["hidden_size"], c["num_attention_heads"]
        run = c["run"]
        return cls(
            d=d, layers=c["num_hidden_layers"], heads=heads,
            kv_heads=c.get("num_key_value_heads", heads),
            head_dim=c.get("head_dim") or d // heads,
            ff=c["intermediate_size"], vocab=c["vocab_size"],
            eps=float(c["rms_norm_eps"]),
            tied=bool(c["tie_word_embeddings"]),
            theta=float(c["rope_theta"]),
            init_std=float(c["initializer_range"]),
            compute_dtype=run["compute_dtype"],
            param_dtype=run["param_dtype"])

    def layer_matrices(self) -> list[tuple[str, tuple[int, int]]]:
        """Each layer's matrices under the program's leaf names, in the
        order they are drawn."""
        d, f = self.d, self.ff
        return [("attn.wq", (d, self.q_dim)), ("attn.wk", (d, self.kv_dim)),
                ("attn.wv", (d, self.kv_dim)), ("attn.wo", (self.q_dim, d)),
                ("mlp.gate", (d, f)), ("mlp.up", (d, f)),
                ("mlp.down", (f, d))]

    def layer_vectors(self) -> list[str]:
        return ["ln1.scale", "ln2.scale"]

    def layer_matrix_params(self) -> int:
        return sum(a * b for _, (a, b) in self.layer_matrices())

    def token_matmul_params(self) -> int:
        """Weights of every product a token runs through, for the
        yardstick's model FLOPs: every layer's matrices (with no bias) and
        the unembedding (the embedding table itself is a lookup)."""
        return self.layers * self.layer_matrix_params() + self.d * self.vocab

    @property
    def attention_layers(self) -> int:
        """Layers that run causal attention over the whole context."""
        return self.layers


def program_fields(dm: Dims, c: dict) -> dict:
    """The fields of the program's ``ModelConfig`` that the file fixes:
    a dense decoder of attention blocks, at the file's sizes."""
    run = c["run"]
    return {"family": "dense", "block_pattern": ("attn",),
            "n_layers": dm.layers, "d_model": dm.d, "n_heads": dm.heads,
            "n_kv_heads": dm.kv_heads, "head_dim": dm.head_dim,
            "d_ff": dm.ff, "vocab_size": dm.vocab, "norm_eps": dm.eps,
            "mlp_variant": "swiglu", "pos_type": "rope",
            "rope_theta": dm.theta, "tie_embeddings": dm.tied,
            "embeds_input": False, "window": 0,
            "compute_dtype": dm.compute_dtype,
            "param_dtype": dm.param_dtype, "remat": bool(run["remat"])}


def highest_precision():
    """Float32 products in full float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def matmul(x, w):
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope_cos_sin(dm: Dims, S: int, device):
    """cos and sin (S, head_dim) of positions 0..S-1: the angles of
    ``cat(freqs, freqs)``, worked out in float64."""
    D = dm.head_dim
    inv = 1.0 / dm.theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                          device=device) / D)
    f = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([f, f], dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def attention(q, k, v):
    """Causal GQA attention, float32; q (B, S, H, D), k, v (B, S, KV, D).
    Heads are taken a block of kv heads at a time."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    g = H // KV
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    step = max(1, SCORE_BLOCK // (B * g * S * S))
    outs = []
    for a in range(0, KV, step):
        b = min(KV, a + step)
        n = b - a
        qs = q[:, :, a * g:b * g].reshape(B, S, n, g, D)
        qs = qs.permute(0, 2, 3, 1, 4)                      # (B, n, g, S, D)
        ks = k[:, :, a:b].permute(0, 2, 1, 3)[:, :, None]   # (B, n, 1, S, D)
        vs = v[:, :, a:b].permute(0, 2, 1, 3)[:, :, None]
        s = (qs @ ks.transpose(-1, -2)) * D ** -0.5         # (B, n, g, S, S)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = (p @ vs).permute(0, 3, 1, 2, 4)                 # (B, S, n, g, D)
        outs.append(o.reshape(B, S, n * g, D))
    return torch.cat(outs, dim=2)


def layer(dm: Dims, p: dict, x, cos, sin, mm=matmul):
    """One block: x + attn(norm(x)), then + mlp(norm(x)).  ``p`` holds the
    layer's leaves under their short names (``attn.wq``, ``ln1.scale``);
    x is (B, S, d) at positions 0..S-1."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln1.scale"], dm.eps)
    q = mm(h, p["attn.wq"]).view(B, S, dm.heads, dm.head_dim)
    k = mm(h, p["attn.wk"]).view(B, S, dm.kv_heads, dm.head_dim)
    v = mm(h, p["attn.wv"]).view(B, S, dm.kv_heads, dm.head_dim)
    c, s = cos[:S, None], sin[:S, None]                     # (S, 1, D)
    q = q * c + _rotate_half(q) * s
    k = k * c + _rotate_half(k) * s
    x = x + mm(attention(q, k, v).reshape(B, S, dm.q_dim), p["attn.wo"])
    h = rms_norm(x, p["ln2.scale"], dm.eps)
    m = F.silu(mm(h, p["mlp.gate"])) * mm(h, p["mlp.up"])
    return x + mm(m, p["mlp.down"])


def layer_params(params: dict, i: int) -> dict:
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def unembedding(dm: Dims, params: dict):
    return params["embed"].T if dm.tied else params["lm_head"]


# -- serving ------------------------------------------------------------------

@torch.no_grad()
def serve_logits(dm: Dims, embed, layer_of, head, final_norm, requests,
                 mm=matmul):
    """Float32 logits of a full forward over each of ``requests`` (a list
    of (token ids (S,), n_last)): the (n_last, vocab) logits of its last
    ``n_last`` positions.  ``embed`` (vocab, d) and ``head`` (d, vocab)
    float32; ``layer_of(i)`` gives layer i's leaves, each asked for once,
    and every request goes through a layer before the next is asked."""
    dev = embed.device
    longest = max(int(t.numel()) for t, _ in requests)
    cos, sin = rope_cos_sin(dm, longest, dev)
    xs = [embed[t.to(dev).long()][None] for t, _ in requests]
    for i in range(dm.layers):
        p = layer_of(i)
        xs = [layer(dm, p, x, cos, sin, mm) for x in xs]
        del p
    out = []
    for x, (_, n) in zip(xs, requests):
        h = rms_norm(x[0, -n:], final_norm, dm.eps)
        out.append(mm(h, head))
    return out


# -- training -----------------------------------------------------------------

def lr_at(update: int, tc: dict) -> float:
    """Learning rate of the ``update``-th update (1-based): linear warm-up,
    then a cosine to a tenth of the base."""
    base, warm, total = (tc["learning_rate"], tc["warmup_steps"],
                         tc["total_steps"])
    if update < warm:
        return base * update / max(warm, 1)
    frac = min(max((update - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


def hidden(dm: Dims, params: dict, x, mm=matmul, remat=False):
    """The final-normed hidden states of x (B, S, d)."""
    cos, sin = rope_cos_sin(dm, x.shape[1], x.device)
    for i in range(dm.layers):
        p = layer_params(params, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer, dm, p, x, cos, sin, mm, use_reentrant=False)
        else:
            x = layer(dm, p, x, cos, sin, mm)
    return rms_norm(x, params["final_norm"], dm.eps)


def loss_and_grads(dm: Dims, params: dict, batch: dict, row_chunk: int,
                   mm=matmul):
    """Mean next-token cross-entropy plus 1e-4 mean(logz^2) over every
    position of ``batch`` (tokens (B, S), labels (B, S)), and the gradient
    of each leaf, taken ``row_chunk`` rows at a time."""
    for p in params.values():
        p.grad = None
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = labels.shape
    n = B * S
    total = 0.0
    for a in range(0, B, row_chunk):
        x = params["embed"][tokens[a:a + row_chunk].long()]
        h = hidden(dm, params, x, mm, remat=True)
        logits = mm(h, unembedding(dm, params))
        logz = torch.logsumexp(logits, dim=-1)
        rows = labels[a:a + row_chunk, :, None].long()
        gold = logits.gather(-1, rows)[..., 0]
        part = ((logz - gold).sum() + 1e-4 * logz.pow(2).sum()) / n
        part.backward()
        total += float(part.detach())
        del x, h, logits, logz, gold, part
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in params.items()}
    return total, grads


def train(dm: Dims, params: dict, batch_of, tc: dict, steps: int,
          row_chunk: int, start_leaves, mm=matmul):
    """``steps`` updates of ``params`` (name -> float32 leaf, changed in
    place) on ``batch_of(i)``.  Returns each step's loss, each leaf's
    gradient norm at the first step (before clipping) and each leaf's
    change over all the steps, against ``start_leaves()``: the starting
    leaves drawn again, (name, tensor) one at a time, so that no copy of
    the start is held."""
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
        gnorm = math.sqrt(sum(x * x for x in norms.values()))
        scale = min(1.0, tc["grad_clip"] / max(gnorm, 1e-9))
        lr = lr_at(t, tc)
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
