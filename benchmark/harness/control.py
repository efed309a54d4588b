"""The lower-precision control: the reference computed with every operand
of its products (matmul, einsum, linear, convolution) rounded to the next
precision below the configuration's, and fp32 accumulation, as tensor
cores of that precision compute:

- 'fp8': float8 e4m3 with one scale per tensor (its amax to 448), for a
  bfloat16 configuration;
- 'tf32': the 10-bit mantissa of TF32, rounded to nearest even, for a
  float32 configuration with TF32 off.

The same rounding runs on the CPU and the card, so the CPU tests run the
same control as the chip.  Under autograd the rounded operands are what
the backward's products see; the gradient passes the rounding unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.bmm,
            torch.mm, torch.einsum, F.linear, F.conv2d, torch.conv2d, torch.addmm, torch.baddbmm}
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) >> 13) << 13
    keep = ~torch.isfinite(x.float())
    return torch.where(keep, x.float(), rounded.view(torch.float32))


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Rounded(TorchFunctionMode):
    def __init__(self, fmt: str):
        super().__init__()
        self.round = {"fp8": round_fp8, "tf32": round_tf32}[fmt]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            args = tuple(self._round(a) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                         for a in args)
        return func(*args, **kwargs)

    def _round(self, a: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            r = self.round(a).to(a.dtype)
        # the gradient passes the rounding unchanged
        return a + (r - a).detach() if a.requires_grad else r
