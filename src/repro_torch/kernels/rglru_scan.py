"""Gated linear recurrence (the RG-LRU core), forward and backward: the
Hopper kernels, their plain PyTorch versions and the autograd Function
that pairs them.

:func:`linear_recurrence` is the port of the Pallas kernel
``repro/kernels/rglru_scan.py``; :func:`linear_recurrence_bwd` is the port
of XLA's autodiff of ``repro.kernels.ops.linear_recurrence(impl="assoc")``,
through which ``repro/models/rglru.py`` trains.  Both live in
``csrc/rglru_scan.cu`` (what they compute, what bounds them and how they
are laid out are written at the top of that file).  :class:`LinearRecurrence`
is the ``torch.autograd.Function`` of the training path: the forward
kernel, which then also writes its float32 states, and the backward
kernel, which reads them.

A CPU tensor goes to the plain versions; a CUDA tensor goes to the
kernel, which is built at first use, or the call raises.
``linear_recurrence.launches`` counts the forward's launches, one a call,
and ``linear_recurrence.launches_by_kernel`` splits them by the kernel the
launch chose: ``"chunked"`` (the TMA ring, S >= 16 with rows TMA can
address) or ``"loop"`` (a thread per channel: decode steps and other
shapes).  ``linear_recurrence_bwd.launches`` counts the backward's, one a
call, and ``linear_recurrence_bwd.launches_by_kernel`` splits them the
same way: ``"chunked"`` (a reverse TMA ring over 32-channel slices, at
any S where a, g, the states, da and db have rows TMA can address) or
``"loop"`` (a thread per channel: W = 1001, misaligned views).  The
choice depends on shape and alignment alone.

:func:`linear_recurrence_plain` is the counterpart of
``repro.kernels.ref.linear_recurrence``: a sequential loop with a float32
state, each step's output and the last state rounded to the input type.
:func:`linear_recurrence_bwd_plain` runs that loop's chain in reverse, as
torch.autograd through it does, to the bit.  The kernels are built
without FMA contraction, so they round every multiply and add as these
loops do on the card.
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


def _states_plain(a, b, h0):
    """The plain loop's float32 states h_t, (B, S, W)."""
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out


def linear_recurrence_plain(a, b, h0=None):
    """The plain PyTorch version of :func:`linear_recurrence`."""
    _check(a, b, h0)
    out = _states_plain(a, b, h0)
    return out.to(a.dtype), out[:, -1].to(a.dtype)


def _check_bwd(a, states, g, g_last, h0):
    _check(a, a, h0)
    B, S, W = a.shape
    if tuple(states.shape) != (B, S, W) or states.dtype != torch.float32 \
            or states.device != a.device or not states.is_contiguous():
        raise ValueError(f"states must be float32 {(B, S, W)} on "
                         f"{a.device}, contiguous; got "
                         f"{tuple(states.shape)} {states.dtype} on "
                         f"{states.device}")
    for name, x, shape in (("g", g, (B, S, W)), ("g_last", g_last, (B, W))):
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != a.dtype \
                or x.device != a.device or not x.is_contiguous():
            raise ValueError(f"{name} must be {a.dtype} {shape} on "
                             f"{a.device}, contiguous; got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def linear_recurrence_bwd_plain(a, states, g=None, g_last=None, h0=None):
    """The plain PyTorch version of :func:`linear_recurrence_bwd`: the
    forward's chain in reverse with a float32 carry."""
    _check_bwd(a, states, g, g_last, h0)
    B, S, W = a.shape
    af = a.float()
    carry = None if g_last is None else g_last.float()
    h_init = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
              if h0 is None else h0.float())
    da = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    for t in range(S - 1, -1, -1):
        if g is None:
            dh = torch.zeros_like(h_init) if carry is None else carry
        else:
            dh = g[:, t].float() if carry is None else g[:, t].float() + carry
        da[:, t] = dh * (states[:, t - 1] if t > 0 else h_init)
        db[:, t] = dh
        carry = dh * af[:, t]
    dh0 = None if h0 is None else carry.to(a.dtype)
    return da.to(a.dtype), db.to(a.dtype), dh0


@functools.cache
def _library():
    lib = _build.load("rglru_scan")
    fn = lib.linear_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.linear_recurrence_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.linear_recurrence_error_string.argtypes = [ctypes.c_int]
    lib.linear_recurrence_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel failed: cudaError {err} "
            f"({lib.linear_recurrence_error_string(err).decode()})")


def _device(x, what):
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev.type}")
    return dev


def _forward(a, b, h0, keep_states):
    """(h, h_last, states): the forward, with its float32 states (B, S, W)
    where ``keep_states``, else None."""
    _check(a, b, h0)
    dev = _device(a, "linear_recurrence")
    if dev.type == "cpu":
        # copies, so that no output is a view of another or of the states
        states = _states_plain(a, b, h0)
        return (states.to(a.dtype, copy=True),
                states[:, -1].to(a.dtype, copy=True),
                states if keep_states else None)
    B, S, W = a.shape
    lib = _library()
    out = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=a.dtype, device=dev)
    states = (torch.empty((B, S, W), dtype=torch.float32, device=dev)
              if keep_states else None)
    kernel_run = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.linear_recurrence_launch(
            a.data_ptr(), b.data_ptr(), _ptr(h0), out.data_ptr(),
            h_last.data_ptr(), _ptr(states), DTYPES[a.dtype], B, S, W,
            ctypes.byref(kernel_run),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "linear_recurrence")
    if kernel_run.value >= 0:          # B * W == 0 launches nothing
        linear_recurrence.launches += 1
        linear_recurrence.launches_by_kernel[
            _KERNEL_NAMES[kernel_run.value]] += 1
    return out, h_last, states


def linear_recurrence(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t along axis 1.

    a, b: (B, S, W) float32 or bfloat16, contiguous; h0: (B, W) of the same
    type, or None for a zero state.  Returns (h (B, S, W), h_last (B, W)),
    both in a's dtype.  Records no gradient: :class:`LinearRecurrence` is
    the differentiable call.
    """
    out, h_last, _ = _forward(a, b, h0, keep_states=False)
    return out, h_last


def linear_recurrence_bwd(a, states, g=None, g_last=None, h0=None):
    """Gradients (da, db, dh0) of :func:`linear_recurrence` at (a, b, h0),
    given its float32 states (B, S, W) (:class:`LinearRecurrence` keeps
    them), the gradient ``g`` of h and ``g_last`` of h_last (either None
    for none), each in a's dtype; dh0 is None where h0 is.  All inputs
    contiguous."""
    _check_bwd(a, states, g, g_last, h0)
    dev = _device(a, "linear_recurrence_bwd")
    if dev.type == "cpu":
        return linear_recurrence_bwd_plain(a, states, g, g_last, h0)
    B, S, W = a.shape
    lib = _library()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    kernel_run = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.linear_recurrence_bwd_launch(
            a.data_ptr(), states.data_ptr(), _ptr(g), _ptr(g_last),
            _ptr(h0), da.data_ptr(), db.data_ptr(), _ptr(dh0),
            DTYPES[a.dtype], B, S, W, ctypes.byref(kernel_run),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "linear_recurrence_bwd")
    if kernel_run.value >= 0:          # B * W == 0 launches nothing
        linear_recurrence_bwd.launches += 1
        linear_recurrence_bwd.launches_by_kernel[
            _KERNEL_NAMES[kernel_run.value]] += 1
    return da, db, dh0


_KERNEL_NAMES = ("loop", "chunked")
linear_recurrence.launches = 0
linear_recurrence.launches_by_kernel = dict.fromkeys(_KERNEL_NAMES, 0)
linear_recurrence_bwd.launches = 0
linear_recurrence_bwd.launches_by_kernel = dict.fromkeys(_KERNEL_NAMES, 0)


class LinearRecurrence(torch.autograd.Function):
    """The recurrence with the kernel pair as its forward and backward:
    the forward keeps a, h0 and its float32 states, the backward runs the
    chain in reverse.  ``apply(a, b, h0)`` (h0 may be None) returns
    (h, h_last); the gradients of a, b and h0 come back in their dtypes.
    On CUDA both directions run the kernels (or raise); on the CPU both
    run the plain versions."""

    @staticmethod
    def forward(ctx, a, b, h0):
        out, h_last, states = _forward(a, b, h0, keep_states=True)
        ctx.save_for_backward(a, states, h0)
        ctx.set_materialize_grads(False)
        return out, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, states, h0 = ctx.saved_tensors
        da, db, dh0 = linear_recurrence_bwd(
            a, states, None if g is None else g.contiguous(),
            None if g_last is None else g_last.contiguous(), h0)
        return da, db, (dh0 if ctx.needs_input_grad[2] else None)
