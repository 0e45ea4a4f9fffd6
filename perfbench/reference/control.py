"""The control: the reference computed one precision below what the
configurations state.  Both state bfloat16 products, so the control
rounds each operand of every weight product to float8 e4m3 with one scale
a tensor (its largest magnitude to 448, as fp8 training recipes scale),
then multiplies in float32.  The rounding passes gradients through
unchanged, so a training step's backward runs on the rounded operands."""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in float32;
    the gradient passes straight through."""
    d = t.detach()
    s = FP8_MAX / d.abs().amax().clamp(min=1e-12)
    q = (d * s).to(torch.float8_e4m3fn).float() / s
    return t + (q - d) if t.requires_grad else q


def fp8_matmul(x, w):
    return fp8(x) @ fp8(w)
