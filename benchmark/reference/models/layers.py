"""Shared layers (counterpart of cofii2p_tpu/models/layers.py).

Parameters stay fp32; ``dtype`` is the compute dtype.  Normalisation
statistics are always taken in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def instance_norm(x: torch.Tensor, dims, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm over ``dims`` (biased variance, fp32
    statistics), returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` (params stay fp32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class PointGroupNorm(nn.Module):
    """GroupNorm over a whole point cloud: statistics per (frame, group)
    over all N points and the group's C/G channels, in fp32
    (cofii2p_tpu/models/layers.py:50-84).  Input (B, N, C)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        g = self.num_groups
        xg = x.float().reshape(*x.shape[:-1], g, x.shape[-1] // g)
        mean = xg.mean(dim=(-3, -1), keepdim=True)
        var = xg.var(dim=(-3, -1), keepdim=True, unbiased=False)
        out = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (out * self.weight + self.bias).to(x.dtype)


class GroupNormWrapper(nn.Module):
    """Holds the norm as ``.norm``, the reference's module layout
    (state-dict keys ``<block>.norm.norm.weight``)."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.norm = PointGroupNorm(num_groups, channels)

    def forward(self, x):
        return self.norm(x)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with fp32 statistics, output in x's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class PointLayerNorm(nn.LayerNorm):
    """The point branch's LayerNorm over channels (eps 1e-5), fp32
    statistics and an fp32 result whatever x's dtype, as flax's LayerNorm
    promotes a bf16 input against its fp32 parameters
    (cofii2p_tpu/models/layers.py:87-92).  State-dict keys
    ``<block>.norm.weight``: the module sits where the reference's
    get_norm puts its nn.LayerNorm."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def norm_factory(norm: str, group_norm: int, channels: int) -> nn.Module:
    """The point blocks' normalisation (cofii2p_tpu/models/layers.py:119-125):
    'gn' a whole-cloud GroupNorm, 'ln' a LayerNorm; anything else raises."""
    if norm == "gn":
        return GroupNormWrapper(group_norm, channels)
    if norm == "ln":
        return PointLayerNorm(channels)
    raise ValueError(f"unsupported point-branch norm {norm!r} (reference supports bn/ln/gn; only gn/ln are used)")
