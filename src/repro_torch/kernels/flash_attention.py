"""FlashAttention-2 forward: the Hopper kernel and its plain PyTorch version.

:func:`flash_attention` is the port of the Pallas kernel
``repro/kernels/flash_attention.py``; its CUDA source is
``csrc/flash_attention.cu`` (what it computes, what bounds it and how it is
laid out are written at the top of that file).  A CPU tensor goes to
:func:`flash_attention_plain`; a CUDA tensor goes to the kernel, which is
built at first use, or the call raises.  ``flash_attention.launches``
counts the kernel launches made.

:func:`flash_attention_plain` is the counterpart of
``repro.kernels.ref.attention``: the whole score matrix in float32, masked
with -1e30, a softmax, and the output rounded to the input type.  The
kernel's online softmax sums in another order, so the two agree to
rounding: about 1e-5 in float32, and within a bf16 ulp or two of the
output in bfloat16, where the kernel runs both products on the tensor
cores with bf16 operands and float sums, P split into bf16 hi + lo halves
(the rounding is rehearsed on the CPU in
``tests/test_torch_attention_kernels.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)          # the kernel's instances


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Sk, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B and D, KV dividing H)")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} is not one of {list(DTYPES)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """The plain PyTorch version of :func:`flash_attention`."""
    _check(q, k, v)
    _, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


@functools.cache
def _library():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Causal / sliding-window GQA attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D), float32 or bfloat16,
    contiguous.  ``window`` > 0 lets each query see only the last
    ``window`` keys; causal offsets put q at the final Sq positions of the
    Sk-long context.  Returns (B, Sq, H, D) in q's dtype.
    """
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, not {D}")
    if Sq > Sk:
        raise ValueError(f"the kernel needs Sq <= Sk, got {Sq} > {Sk}")
    scale = D ** -0.5 if scale is None else scale
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, Sq, Sk, H, KV, D, float(scale), int(causal),
            int(window), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel failed: cudaError {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
