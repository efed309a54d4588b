"""ResNet-34 image encoder and the image upsampling decoder (counterpart of
cofii2p_tpu/models/resnet.py).

Public inputs and outputs keep the JAX package's NHWC layout; inside,
tensors are NCHW, the layout cuDNN convolves.  Module names follow the
reference layout (``img_encoder.backbone.layer1.0.conv1.weight``,
``img_upsample_1.conv.0.bn1.running_mean``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cofii2p_tpu_torch.models.layers import instance_norm


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """Bias-free 'same'-padded conv computing in ``dtype`` (params fp32)."""

    def __init__(self, cin, cout, kernel, stride=1, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics, fp32 math, output in x's dtype.

    ``train=False`` normalises with the running statistics.  ``train=True``
    normalises with the batch's mean and biased variance, taken as
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), and updates the
    running statistics in place, running = 0.9 running + 0.1 batch with the
    biased variance (cofii2p_tpu/models/resnet.py:120-123): the port's
    counterpart of JAX's mutable ``batch_stats``.  ``F.batch_norm`` in
    training mode would store the unbiased variance instead.
    """

    def forward(self, x, train: bool = False):
        x32 = x.float()
        if not train:
            return F.batch_norm(
                x32, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps,
            ).to(x.dtype)
        mean = x32.mean(dim=(0, 2, 3))
        var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class BasicBlock(nn.Module):
    """Two 3x3 convs with parameter-free instance norms and an identity or
    projection shortcut (reference imagenet.py:36-73)."""

    def __init__(self, cin, cout, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, dtype)
        self.conv2 = Conv2d(cout, cout, 3, 1, dtype)
        self.downsample = (
            nn.Sequential(Conv2d(cin, cout, 1, stride, dtype)) if stride != 1 or cin != cout else None
        )

    def forward(self, x):
        out = F.relu(instance_norm(self.conv1(x), (2, 3)))
        out = instance_norm(self.conv2(out), (2, 3))
        identity = x if self.downsample is None else instance_norm(self.downsample(x), (2, 3))
        return F.relu(out + identity)


class _Backbone(nn.Module):
    def __init__(self, stage_sizes, stage_features, dtype):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, dtype)
        cin = 64
        for stage, (blocks, feats) in enumerate(zip(stage_sizes, stage_features)):
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock(cin, feats, stride if b == 0 else 1, dtype))
                cin = feats
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)


class ResNetEncoder(nn.Module):
    """ResNet image encoder: (B, H, W, 3) -> NHWC pyramid
    [/2, /4, /8, /16, /32, global average] (reference imagenet.py:196-217)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), stage_features=(64, 128, 256, 512), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = _Backbone(stage_sizes, stage_features, dtype)

    def forward(self, img):
        bb = self.backbone
        x = F.relu(instance_norm(bb.conv1(nchw(img).to(self.dtype)), (2, 3)))
        out = [x]
        # MaxPool2d(3, 2, padding=1) pads with -inf, like resnet.py:88-93
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in range(bb.num_stages):
            x = getattr(bb, f"layer{stage + 1}")(x)
            out.append(x)
        out.append(x.mean(dim=(2, 3), keepdim=True))
        return [nhwc(o) for o in out]


class ResidualConv(nn.Module):
    """Decoder residual conv with BatchNorm (reference imagenet.py:377-411)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv_skip = nn.Sequential(Conv2d(cin, cout, 3, 1, dtype), BatchNorm2d(cout))
        self.conv1 = Conv2d(cin, cout, 3, 1, dtype)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, dtype)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x, train: bool = False):
        identity = self.conv_skip[1](self.conv_skip[0](x), train)
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return F.relu(out + identity)


class ImageUpSample(nn.Module):
    """Bilinear x2 upsample (half-pixel centres, edge-clamped: what
    ``jax.image.resize(..., 'bilinear')`` computes when upsampling) + skip
    concat + 2 residual convs.  NHWC in, NHWC out; ``train`` puts the
    BatchNorms in training mode."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(ResidualConv(cin, cout, dtype), ResidualConv(cout, cout, dtype))

    def forward(self, x_coarse, x_skip, train: bool = False):
        up = F.interpolate(nchw(x_coarse), scale_factor=2, mode="bilinear", align_corners=False)
        x = torch.cat([up, nchw(x_skip).to(up.dtype)], dim=1)
        for res in self.conv:
            x = res(x, train)
        return nhwc(x)
