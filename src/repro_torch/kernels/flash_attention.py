"""FlashAttention-2, forward and backward: the Hopper kernels, their plain
PyTorch versions and the autograd Function that pairs them.

:func:`flash_attention` is the port of the Pallas kernel
``repro/kernels/flash_attention.py``; its CUDA source is
``csrc/flash_attention.cu`` (what it computes, what bounds it and how it is
laid out are written at the top of that file).  With ``return_lse=True`` it
also returns the row log-sum-exp, float32 (B, Sq, H), as
``repro.kernels.ops._flash_fwd_shaped`` does.  :func:`flash_attention_bwd`
is the port of ``repro.kernels.ops._flash_bwd`` (the XLA backward under
``flash_attention_xla``'s custom_vjp); its source is
``csrc/flash_attention_bwd.cu``: two kernels (dq, then dk and dv summed
over each GQA group inside one block), deterministic (no atomics).  Both
take head dims 64, 128 and 256 (recurrentgemma's local attention; there
each backward kernel's output columns are cut into two 128-wide halves, a
block each).  ``segments``, int32 offsets ``seg[0] = 0 < ... <= seg[n] =
S`` of one packed sequence (B = 1), let a query see only the keys of its
own segment, causal or not: the images of Qwen2-VL's vision tower, whose
heads are 80 wide, so on the card the pair takes segments at D 80 in
bfloat16 (an instance of its own; tiles padded to two 64-column panels
inside the kernel), and the plain versions at any D.
In bfloat16 they run their five products on the tensor cores (wgmma fed
by TMA), P and dS passed as bf16 hi + lo halves; in float32 they stay on
the CUDA cores in full float32.  :class:`FlashAttention`
is the ``torch.autograd.Function`` of the training path: the forward
kernel with LSE, then the backward kernel.

A CPU tensor goes to the plain versions; a CUDA tensor goes to the
kernel, which is built at first use, or the call raises.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
the kernel launches made (one a call; the backward's call runs its two
kernels, dq then dk/dv).

:func:`flash_attention_plain` is the counterpart of
``repro.kernels.ref.attention``: the whole score matrix in float32, masked
with -1e30, a softmax, and the output rounded to the input type.  The
kernel's online softmax sums in another order, so the two agree to
rounding: about 1e-5 in float32, and within a bf16 ulp or two of the
output in bfloat16, where the kernel runs both products on the tensor
cores with bf16 operands and float sums, P split into bf16 hi + lo halves
(the rounding is rehearsed on the CPU in
``tests/test_torch_attention_kernels.py``; the backward's, with P and dS
split, in ``tests/test_torch_flash_bwd.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)          # the forward kernel's instances
BWD_HEAD_DIMS = (64, 128, 256)      # the backward kernel's instances
SEGMENT_HEAD_DIMS = (80,)           # both kernels' instances with segments


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


def _logits(q, k, causal, window, scale):
    """Scaled, masked float32 logits (B, H, Sq, Sk), k repeated over the
    query heads of its group."""
    sq, sk = q.shape[1], k.shape[1]
    k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return torch.where(mask, logits, NEG_INF)


def _check_segments(q, k, segments):
    """``segments`` as a list of Python ints, checked against q and k
    (B = 1, Sq = Sk = the last offset, offsets ascending from 0)."""
    seg = [int(x) for x in segments.tolist()] if torch.is_tensor(segments) \
        else [int(x) for x in segments]
    B, Sq = q.shape[:2]
    if B != 1 or k.shape[1] != Sq:
        raise ValueError(f"segments need B = 1 and Sq = Sk; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if len(seg) < 2 or seg[0] != 0 or seg[-1] != Sq or any(
            b < a for a, b in zip(seg, seg[1:])):
        raise ValueError(f"segments must ascend from 0 to Sq = {Sq}; got "
                         f"{seg[:4]}...{seg[-2:]} ({len(seg)} offsets)")
    return seg


def _per_segment(fn, seg, *xs):
    """``fn`` of each segment's slice (axis 1) of ``xs``, its outputs
    joined along axis 1 again."""
    parts = [fn(*(x[:, a:b] for x in xs)) for a, b in zip(seg, seg[1:])
             if b > a]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None,
                          return_lse: bool = False, segments=None):
    """The plain PyTorch version of :func:`flash_attention`; with
    ``segments``, the unsegmented version over each segment in turn."""
    _check(q, k, v)
    if segments is not None:
        out, lse = _per_segment(
            lambda *x: flash_attention_plain(
                *x, causal=causal, window=window, scale=scale,
                return_lse=True), _check_segments(q, k, segments), q, k, v)
        return (out, lse) if return_lse else out
    scale = q.shape[3] ** -0.5 if scale is None else scale
    logits = _logits(q, k, causal, window, scale)
    p = torch.softmax(logits, dim=-1)
    v = v.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).transpose(1, 2).contiguous()


def _check_kernel_dims(q, k, segments, dims):
    """What the kernels take: head dims ``dims`` unsegmented; segments
    at ``SEGMENT_HEAD_DIMS`` in bfloat16, B = 1 and Sq = Sk, as a
    contiguous 1-D int32 tensor on q's device."""
    B, Sq, _, D = q.shape
    if Sq > k.shape[1]:
        raise ValueError(f"the kernel needs Sq <= Sk, got {Sq} > "
                         f"{k.shape[1]}")
    if segments is None:
        if D not in dims:
            raise ValueError(f"the kernel takes head_dim in {dims}, not {D}")
        return
    if D not in SEGMENT_HEAD_DIMS or q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes segments at head_dim in "
                         f"{SEGMENT_HEAD_DIMS} in bfloat16, not {D} in "
                         f"{q.dtype}")
    if B != 1 or Sq != k.shape[1]:
        raise ValueError(f"segments need B = 1 and Sq = Sk; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if not torch.is_tensor(segments) or segments.dtype != torch.int32 \
            or segments.device != q.device or segments.ndim != 1 \
            or not segments.is_contiguous():
        raise ValueError("the kernel takes segments as a contiguous 1-D "
                         "int32 tensor on q's device")


@functools.cache
def _library():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, return_lse: bool = False,
                    segments=None):
    """Causal / sliding-window GQA attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D), float32 or bfloat16,
    contiguous.  ``window`` > 0 lets each query see only the last
    ``window`` keys; causal offsets put q at the final Sq positions of the
    Sk-long context.  ``segments``: None, or the offsets of packed
    segments (B = 1, Sq = Sk; on the card a 1-D int32 tensor on q's
    device), each query seeing only its own segment's keys.  Returns
    (B, Sq, H, D) in q's dtype and, with ``return_lse``, the row
    log-sum-exp of the scaled, masked logits, float32 (B, Sq, H).
    """
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, return_lse=return_lse,
                                     segments=segments)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    _check_kernel_dims(q, k, segments, HEAD_DIMS)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    lib = _library()
    out = torch.empty_like(q)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, Sq, Sk, H, KV, D, float(scale), int(causal),
            int(window), torch.cuda.current_stream(dev).cuda_stream,
            None if lse is None else lse.data_ptr(),
            None if segments is None else segments.data_ptr(),
            0 if segments is None else segments.numel() - 1)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel failed: cudaError {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _check_bwd(q, k, v, out, lse, dout):
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}; q is {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}")
    if lse.shape != (B, Sq, H) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 {(B, Sq, H)} on {q.device}; "
                         f"got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              segments=None):
    """The plain PyTorch version of :func:`flash_attention_bwd`: every
    (B, H, Sq, Sk) matrix in float32 at once, P recomputed from lse, and
    dk, dv summed over the query heads of each group; with ``segments``,
    the unsegmented version over each segment in turn."""
    _check_bwd(q, k, v, out, lse, dout)
    if segments is not None:
        return _per_segment(
            lambda *x: flash_attention_bwd_plain(
                *x, causal=causal, window=window, scale=scale),
            _check_segments(q, k, segments), q, k, v, out, lse, dout)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = D ** -0.5 if scale is None else scale
    p = torch.exp(_logits(q, k, causal, window, scale)
                  - lse.transpose(1, 2)[..., None])
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf, dof = q.float(), dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Sk, KV, rep, D).sum(3)
    dv = dv.reshape(B, Sk, KV, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bind_bwd(lib):
    """Declare the C interface of a library built from
    ``csrc/flash_attention_bwd.cu``; returns ``lib``."""
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library():
    return bind_bwd(_build.load("flash_attention_bwd"))


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, scale: float | None = None,
                        segments=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at (q, k, v),
    given its output ``out``, its row log-sum-exp ``lse`` (float32
    (B, Sq, H)) and the output gradient ``dout``; each in its input's
    dtype, dk and dv summed over the query heads of a group.  All inputs
    contiguous; head dim 64, 128 or 256 on the card, or 80 with
    ``segments`` as :func:`flash_attention` takes them."""
    _check_bwd(q, k, v, out, lse, dout)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         scale=scale, segments=segments)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    _check_kernel_dims(q, k, segments, BWD_HEAD_DIMS)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not (out.is_contiguous() and dout.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("out, dout and lse must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v, out, dout)):
        raise ValueError("the kernel loads 16 bytes at a time: q, k, v, out "
                         "and dout must start on a 16-byte boundary")
    scale = D ** -0.5 if scale is None else scale
    lib = _bwd_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # filled by the call: delta (B, Sq, H) for the float32 kernels; lse and
    # delta, each (B, H, Sq rounded up to a 64-query tile), for the bf16 ones
    scratch = torch.empty(2 * B * H * (-(-Sq // 64) * 64),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], B, Sq, Sk, H, KV,
            D, float(scale), int(causal), int(window),
            torch.cuda.current_stream(dev).cuda_stream,
            None if segments is None else segments.data_ptr(),
            0 if segments is None else segments.numel() - 1)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel failed: cudaError {err} "
            f"({lib.flash_attention_bwd_error_string(err).decode()})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with the flash pair as its forward and backward, the
    counterpart of ``repro.kernels.ops.flash_attention_xla``'s custom_vjp:
    the forward keeps (q, k, v, out, lse), the backward recomputes P from
    them.  On CUDA both directions run the kernels (or raise); on the CPU
    both run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, segments=None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True,
                                   segments=segments)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        segments=segments)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None
