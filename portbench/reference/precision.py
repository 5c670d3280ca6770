"""How the reference computes its products.

"fp32": full float32, TF32 off (the reference itself).
"tf32": float32 with TF32 on for cuBLAS and cuDNN (the control of a
        float32 configuration: the step below it that tempts a speed-up).
"fp8":  every product's two operands rounded to float8 e4m3 with one scale
        a tensor, accumulated in float32 (the control of a bfloat16
        configuration).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale (amax / 448), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}: expected one of {MODES}")
        self.mode = mode

    def round(self, x):
        """x as this mode feeds a product: e4m3-rounded in fp8, else itself."""
        return fp8_round(x) if self.mode == "fp8" else x

    def linear(self, x, w, b=None):
        return F.linear(self.round(x), self.round(w), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.round(a), self.round(b))

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self.round(x), self.round(w), b, **kw)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.round(x), self.round(w), b, **kw)

    @contextlib.contextmanager
    def active(self):
        """Sets the process's TF32 flags for this mode while inside; the
        previous flags come back on exit."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        tf32 = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with torch.no_grad():
                yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
