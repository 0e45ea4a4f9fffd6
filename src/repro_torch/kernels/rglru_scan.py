"""Gated linear recurrence (the RG-LRU core): the Hopper kernel and its
plain PyTorch version.

:func:`linear_recurrence` is the port of the Pallas kernel
``repro/kernels/rglru_scan.py``; its CUDA source is ``csrc/rglru_scan.cu``
(what it computes, what bounds it and how it is laid out are written at
the top of that file).  A CPU tensor goes to
:func:`linear_recurrence_plain`; a CUDA tensor goes to the kernel, which is
built at first use, or the call raises.  The kernel has no backward, and
its outputs, written through ctypes, carry no ``grad_fn``; so the CUDA
branch raises where autograd would record (:func:`refuse_autograd`) rather
than drop gradients without an error.  The CPU branch stays
differentiable.  ``linear_recurrence.launches``
counts the kernel launches made, one a call, and
``linear_recurrence.launches_by_kernel`` splits them by the kernel the
launch chose: ``"chunked"`` (the TMA ring, S >= 16 with rows TMA can
address) or ``"loop"`` (a thread per channel: decode steps and other
shapes).

:func:`linear_recurrence_plain` is the counterpart of
``repro.kernels.ref.linear_recurrence``: a sequential loop with a float32
state, each step's output and the last state rounded to the input type.
The kernel is built without FMA contraction, so it rounds every multiply
and add as this loop does on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import DTYPES


def _check(a, b, h0):
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"need a, b of one shape (B, S, W); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[1] == 0:
        raise ValueError("the recurrence needs S >= 1")
    xs = [("b", b)] + ([] if h0 is None else [("h0", h0)])
    for name, x in xs:
        if x.dtype != a.dtype or x.device != a.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, a is "
                             f"{a.dtype} on {a.device}")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B, W) = {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"dtype {a.dtype} is not one of {list(DTYPES)}")
    if not all(x.is_contiguous() for _, x in xs + [("a", a)]):
        raise ValueError("a, b and h0 must be contiguous")


def refuse_autograd(a, b, h0=None):
    """Raise ``RuntimeError`` when autograd would record a call: grad mode
    is on and one of ``a``, ``b``, ``h0`` requires grad.  The CUDA branch
    of :func:`linear_recurrence` calls it before launching."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, b, h0)):
        raise RuntimeError(
            "linear_recurrence's CUDA kernel has no backward, so its outputs "
            "would carry no gradient; call it under torch.no_grad() or on "
            "inputs that do not require grad (the RG-LRU backward is "
            "ROADMAP.md queue 1 item 2)")


def linear_recurrence_plain(a, b, h0=None):
    """The plain PyTorch version of :func:`linear_recurrence`."""
    _check(a, b, h0)
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype), h.to(a.dtype)


@functools.cache
def _library():
    lib = _build.load("rglru_scan")
    fn = lib.linear_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.linear_recurrence_error_string.argtypes = [ctypes.c_int]
    lib.linear_recurrence_error_string.restype = ctypes.c_char_p
    return lib


def linear_recurrence(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t along axis 1.

    a, b: (B, S, W) float32 or bfloat16, contiguous; h0: (B, W) of the same
    type, or None for a zero state.  Returns (h (B, S, W), h_last (B, W)),
    both in a's dtype.
    """
    _check(a, b, h0)
    dev = a.device
    if dev.type == "cpu":
        return linear_recurrence_plain(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"linear_recurrence runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    refuse_autograd(a, b, h0)
    B, S, W = a.shape
    lib = _library()
    out = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=a.dtype, device=dev)
    kernel_run = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.linear_recurrence_launch(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), h_last.data_ptr(), DTYPES[a.dtype], B, S, W,
            ctypes.byref(kernel_run),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"linear_recurrence kernel failed: cudaError {err} "
            f"({lib.linear_recurrence_error_string(err).decode()})")
    if kernel_run.value >= 0:          # B * W == 0 launches nothing
        linear_recurrence.launches += 1
        linear_recurrence.launches_by_kernel[
            _KERNEL_NAMES[kernel_run.value]] += 1
    return out, h_last


_KERNEL_NAMES = ("loop", "chunked")
linear_recurrence.launches = 0
linear_recurrence.launches_by_kernel = dict.fromkeys(_KERNEL_NAMES, 0)
