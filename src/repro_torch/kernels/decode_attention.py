"""Single-token GQA flash-decode: the Hopper kernel and its plain PyTorch
version.

:func:`decode_attention` is the port of the Pallas kernel
``repro/kernels/decode_attention.py``; its CUDA source is
``csrc/decode_attention.cu`` (what it computes, what bounds it and how it
is laid out are written at the top of that file).  A CPU tensor goes to
:func:`decode_attention_plain`; a CUDA tensor goes to the kernel, which is
built at first use, or the call raises.  ``decode_attention.launches``
counts the kernel launches made (one a call: the split over the cache and
the combine run in the same launch); a CUDA graph that captured a call
launches the kernel again at each replay without passing through the
wrapper, and the code that replays it adds those launches
(``ops.count_launches``).  The wrapper allocates
the kernel's scratch: the chunks' partial sums (``torch.empty``, per call)
and one int32 counter per (b, kv head), zeroed once per device and left
zero by every launch (the last block of each group resets its counter),
so a captured CUDA graph replays on clean counters.  A counter buffer
outgrown by a larger batch is kept, not freed: a graph may still hold its
address.

:func:`decode_attention_plain` is the counterpart of
``repro.kernels.ref.decode_attention``: float32 throughout, invalid cache
slots masked with -1e30, the output rounded to the input type.  That is
also what the Pallas kernel computes; the JAX model's own decode route
(``ops._decode_xla``) instead rounds ``q * scale`` and the probabilities to
the cache's type before the two products.  The kernel sums in another
order, and in bfloat16 runs both products on the tensor cores (bf16
operands, float sums, the probabilities split into bf16 hi + lo halves):
it agrees with the plain version to about 1e-5 in float32 and within a
bf16 ulp or two of the output in bfloat16.  It takes at most
``MAX_GROUP`` query heads per kv head.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, NEG_INF

MAX_GROUP = 16                      # query heads per kv head: the 16 rows
                                    # of the kernel's mma tile
_COUNTERS: dict = {}                # device -> zeroed int32 counters
_OUTGROWN: list = []                # counters replaced by larger ones


def _check(q, k_cache, v_cache, lengths):
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B, H, D) and caches (B, S, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, D = q.shape
    if (k_cache.shape[0] != B or k_cache.shape[3] != D
            or H % k_cache.shape[2]):
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and D, KV dividing H)")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} is not one of {list(DTYPES)}")
    if (tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32
            or lengths.device != q.device):
        raise ValueError(f"lengths must be ({B},) int32 on {q.device}, got "
                         f"{tuple(lengths.shape)} {lengths.dtype} on "
                         f"{lengths.device}")
    if not all(x.is_contiguous() for x in (q, k_cache, v_cache, lengths)):
        raise ValueError("q, the caches and lengths must be contiguous")


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: float | None = None):
    """The plain PyTorch version of :func:`decode_attention`."""
    _check(q, k_cache, v_cache, lengths)
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).reshape(b, kv, h // kv, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = (torch.arange(s, device=q.device)[None, None, None, :]
             < lengths[:, None, None, None])
    p = torch.softmax(torch.where(valid, logits, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


@functools.cache
def _library():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_attention_chunk.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _counters(dev, n: int):
    """``n`` zeroed int32 counters on ``dev``, kept across calls: the
    kernel leaves them zero."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = _COUNTERS[dev] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None):
    """Attention of one new token per sequence over a KV cache.

    q: (B, H, D); k_cache, v_cache: (B, S, KV, D), float32 or bfloat16;
    lengths: (B,) int32, the valid slots of each sequence's cache (slots
    ``>= lengths[b]`` are masked).  Returns (B, H, D) in q's dtype.
    """
    _check(q, k_cache, v_cache, lengths)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, not {D}")
    if H // KV > MAX_GROUP or S == 0:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads "
                         f"per kv head and a nonempty cache; got H/KV = "
                         f"{H // KV}, S = {S}")
    scale = D ** -0.5 if scale is None else scale
    lib = _library()
    n_split = -(-S // lib.decode_attention_chunk())
    pm = torch.empty((n_split, B, H), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((n_split, B, H, D), dtype=torch.float32, device=dev)
    counters = _counters(dev, B * KV)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), pm.data_ptr(), pl.data_ptr(),
            pacc.data_ptr(), counters.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, S, H, KV, D,
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel failed: cudaError {err} "
            f"({lib.decode_attention_error_string(err).decode()})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
