"""KPConv point branch, banded radius neighborhoods (counterpart of
cofii2p_tpu/models/kpconv.py with ``impl='banded'``).

Module and parameter names follow the reference layout that
cofii2p_tpu/utils/checkpoint.py::export_t7 writes (``encoder1_1.KPConv.
weights``, ``encoder2_1.norm_conv.norm.weight``, ...), so a reference
state dict loads with ``strict=True``.

Every KPConv goes through ops/kpconv_kernel.py::banded_kpconv_apply and
every strided shortcut through ops/maxpool_kernel.py::banded_maxpool_apply
when ``kernel`` is 'auto' or 'pallas' (the CUDA kernels on the card, their
plain versions on the CPU): differentiated, through the autograd Functions
whose backwards are kernels too; otherwise the fused KPConv kernel where
``fused_contraction_fits`` (all 14 convs in bf16, 12 in fp32), else the
aggregate kernel and a matmul, as the JAX package chooses.
``kernel='xla'`` calls the plain versions directly under plain autograd,
as the JAX config's 'xla' selects the XLA twins.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cofii2p_tpu_torch.models.kernel_points import load_kernel_points
from cofii2p_tpu_torch.models.layers import GroupNormWrapper, Linear, leaky_relu
from cofii2p_tpu_torch.ops.banded import banded_nearest_index, dynamic_band_starts, kernel_reach
from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_apply, banded_kpconv_fused_plain, fused_contraction_fits
from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_apply, banded_maxpool_plain

KERNELS = ("auto", "pallas", "xla")


class KPConv(nn.Module):
    """Rigid kernel-point convolution over banded radius neighborhoods.

    forward(s_feats (B, N, Cin), q_points (B, M, 3), s_points (B, N, 3),
    starts) -> (B, M, Cout) fp32: the aggregation + contraction, divided
    by the in-reach count, plus bias (kpconv.py:355-382).
    """

    def __init__(self, in_channels, out_channels, kernel_size=15, radius=0.425, sigma=0.2,
                 dtype=torch.float32, tile=128, band_width=1024, kernel="auto"):
        super().__init__()
        if kernel not in KERNELS:
            raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
        self.kernel_size, self.radius, self.sigma = kernel_size, radius, sigma
        self.dtype, self.tile, self.band_width, self.kernel = dtype, tile, band_width, kernel
        bound = 1.0 / np.sqrt(in_channels * out_channels)
        self.weights = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound))
        kp = np.asarray(load_kernel_points(radius, kernel_size, 3), np.float32)
        self.register_buffer("kernel_points", torch.as_tensor(kp))
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.fused = fused_contraction_fits(kernel_size, in_channels, out_channels, tile, wbytes=itemsize)

    def forward(self, s_feats, q_points, s_points, starts=None):
        args = (s_feats, q_points, s_points, self.weights, self.radius, self.sigma,
                self.kernel_size, self.tile, self.band_width, self.dtype, starts)
        if self.kernel == "xla":
            out, count = banded_kpconv_fused_plain(*args)
        else:
            out, count = banded_kpconv_apply(*args, fused=self.fused)
        return out / count[..., None].to(out.dtype) + self.bias


class UnaryBlock(nn.Module):
    """Linear -> group norm -> LeakyReLU(0.1); ``norm=False`` leaves the
    plain Linear (the FPN's last decoder)."""

    def __init__(self, in_channels, out_channels, group_norm=32, has_relu=True, norm=True, dtype=torch.float32):
        super().__init__()
        self.mlp = Linear(in_channels, out_channels, dtype=dtype)
        self.norm = GroupNormWrapper(group_norm, out_channels) if norm else None
        self.has_relu = has_relu and norm

    def forward(self, x):
        x = self.mlp(x)
        if self.norm is not None:
            x = self.norm(x)
        return leaky_relu(x) if self.has_relu else x


class ConvBlock(nn.Module):
    """KPConv -> group norm -> LeakyReLU (reference modules.py:115-159)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm=32, **kw):
        super().__init__()
        self.KPConv = KPConv(in_channels, out_channels, kernel_size, radius, sigma, **kw)
        self.norm = GroupNormWrapper(group_norm, out_channels)

    def forward(self, s_feats, q_points, s_points, starts=None):
        return leaky_relu(self.norm(self.KPConv(s_feats, q_points, s_points, starts)))


class ResidualBlock(nn.Module):
    """Bottleneck residual KPConv block; a strided block's shortcut is the
    banded maxpool of its input (reference modules.py:162-240)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm=32,
                 strided=False, dtype=torch.float32, tile=128, band_width=1024, kernel="auto"):
        super().__init__()
        mid = out_channels // 4
        self.strided, self.tile, self.band_width, self.kernel = strided, tile, band_width, kernel
        self.r_active = kernel_reach(radius, sigma, kernel_size)
        self.unary1 = (
            UnaryBlock(in_channels, mid, group_norm, dtype=dtype) if in_channels != mid else None
        )
        self.KPConv = KPConv(mid, mid, kernel_size, radius, sigma, dtype=dtype, tile=tile,
                             band_width=band_width, kernel=kernel)
        self.norm_conv = GroupNormWrapper(group_norm, mid)
        self.unary2 = UnaryBlock(mid, out_channels, group_norm, has_relu=False, dtype=dtype)
        self.unary_shortcut = (
            UnaryBlock(in_channels, out_channels, group_norm, has_relu=False, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, s_feats, q_points, s_points, starts=None):
        x = s_feats if self.unary1 is None else self.unary1(s_feats)
        x = self.KPConv(x, q_points, s_points, starts)
        x = self.unary2(leaky_relu(self.norm_conv(x)))
        if self.strided:
            fn = banded_maxpool_plain if self.kernel == "xla" else banded_maxpool_apply
            shortcut = fn(s_feats, q_points, s_points, self.r_active, self.tile, self.band_width, starts)
        else:
            shortcut = s_feats
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut)
        return leaky_relu(x + shortcut)


def norm_cancelled_biases(model: nn.Module) -> list:
    """Names of the biases added right before a group norm with one channel
    per group (encoder1_2's and encoder2_1's KPConv and unary1 biases): the
    norm subtracts each again, so their gradient is zero in exact
    arithmetic and only rounding noise in fp32.  Gradient comparisons judge
    these against the model's gradient scale instead of their own."""
    names = []
    for prefix, mod in model.named_modules():
        pairs = []
        if isinstance(mod, UnaryBlock) and mod.norm is not None:
            pairs.append(("mlp.bias", mod.norm))
        elif isinstance(mod, ResidualBlock):
            pairs.append(("KPConv.bias", mod.norm_conv))
        elif isinstance(mod, ConvBlock):
            pairs.append(("KPConv.bias", mod.norm))
        for name, norm in pairs:
            if norm.norm.num_groups == norm.norm.weight.numel():
                names.append(f"{prefix}.{name}" if prefix else name)
    return names


class KPConvFPN(nn.Module):
    """5-stage KPConv encoder + 3-step decoder over a Morton-ordered pyramid
    (reference kp_backbone.py:7-128).

    forward(feats (B, N0, input_dim), points [(B, N_l, 3)]) ->
    [fine (B, N1, output_dim), (B, N2, 512), (B, N3, 1024), latent (B, N4, 2048)].
    """

    def __init__(self, input_dim=4, output_dim=64, init_dim=64, kernel_size=15, init_radius=0.425,
                 init_sigma=0.2, group_norm=32, dtype=torch.float32, tile=128, band_width=1024,
                 band_plan=None, kernel="auto", dynamic_plan=None, dynamic_plan_self=None,
                 dynamic_center="best"):
        super().__init__()
        d, ks, r, s = init_dim, kernel_size, init_radius, init_sigma
        self.tile, self.band_width, self.band_plan = tile, band_width, band_plan
        self.dynamic_plan, self.dynamic_plan_self = dynamic_plan, dynamic_plan_self
        self.dynamic_center, self.kernel_size, self.r, self.s = dynamic_center, ks, r, s
        common = dict(group_norm=group_norm, dtype=dtype, tile=tile, kernel=kernel)

        self.encoder1_1 = ConvBlock(input_dim, d, ks, r, s, band_width=self._bw_for(0, True), **common)
        self.encoder1_2 = ResidualBlock(d, d * 2, ks, r, s, band_width=self._bw_for(0, True), **common)
        for stage, cin, cout in ((2, d * 2, d * 4), (3, d * 4, d * 8), (4, d * 8, d * 16), (5, d * 16, d * 32)):
            lvl = stage - 1
            rs, rc = r * 2 ** (stage - 2), r * 2 ** (stage - 1)
            ss, sc = s * 2 ** (stage - 2), s * 2 ** (stage - 1)
            setattr(self, f"encoder{stage}_1", ResidualBlock(
                cin, cin, ks, rs, ss, strided=True, band_width=self._bw_for(lvl - 1, False), **common))
            setattr(self, f"encoder{stage}_2", ResidualBlock(
                cin, cout, ks, rc, sc, band_width=self._bw_for(lvl, True), **common))
            setattr(self, f"encoder{stage}_3", ResidualBlock(
                cout, cout, ks, rc, sc, band_width=self._bw_for(lvl, True), **common))
        self.decoder4 = UnaryBlock(d * 32 + d * 16, d * 16, group_norm, dtype=dtype)
        self.decoder3 = UnaryBlock(d * 16 + d * 8, d * 8, group_norm, dtype=dtype)
        self.decoder2 = UnaryBlock(d * 8 + d * 4, output_dim, norm=False, dtype=dtype)

    def bw(self, support_lvl: int) -> int:
        """Static half-band of a support level (kpconv.py:738-755)."""
        if self.band_plan is not None:
            if support_lvl < len(self.band_plan):
                return int(self.band_plan[support_lvl])
            return int(self.band_plan[-1]) * 2 ** (support_lvl - len(self.band_plan) + 1)
        return self.band_width * 2**support_lvl

    def dyn_w(self, support_lvl: int, is_self: bool) -> int:
        """Dynamic window width of a pair (0 = static band; kpconv.py:771-792)."""
        plan = self.dynamic_plan
        if is_self and self.dynamic_plan_self is not None:
            plan = self.dynamic_plan_self
        if plan is None:
            return 0
        return int(plan[support_lvl] or 0) if support_lvl < len(plan) else 0

    def _bw_for(self, support_lvl: int, is_self: bool) -> int:
        return self.dyn_w(support_lvl, is_self) or self.bw(support_lvl)

    def starts_for(self, q_pts, s_pts, support_lvl, radius_scale, is_self):
        """One starts tensor per (query level, support level) pair, shared by
        every block on it, or None for a static band (kpconv.py:813-838)."""
        w = self.dyn_w(support_lvl, is_self)
        if w == 0:
            return None
        r_act = kernel_reach(self.r * radius_scale, self.s * radius_scale, self.kernel_size)
        stride = max(1, s_pts.shape[-2] // 2560) if self.dynamic_center == "best" else 1
        return dynamic_band_starts(q_pts, s_pts, r_act, self.tile, w, self.dynamic_center, stride)

    def forward(self, feats, points):
        enc = {}
        st0 = self.starts_for(points[0], points[0], 0, 1, True)
        x = self.encoder1_1(feats, points[0], points[0], st0)
        enc[1] = self.encoder1_2(x, points[0], points[0], st0)
        x = enc[1]
        for stage in range(2, 6):
            lvl = stage - 1
            st_cross = self.starts_for(points[lvl], points[lvl - 1], lvl - 1, 2 ** (stage - 2), False)
            st_self = self.starts_for(points[lvl], points[lvl], lvl, 2 ** (stage - 1), True)
            x = getattr(self, f"encoder{stage}_1")(x, points[lvl], points[lvl - 1], st_cross)
            x = getattr(self, f"encoder{stage}_2")(x, points[lvl], points[lvl], st_self)
            x = getattr(self, f"encoder{stage}_3")(x, points[lvl], points[lvl], st_self)
            enc[stage] = x

        def upsample(coarse, lvl):
            idx = banded_nearest_index(points[lvl], points[lvl + 1], self.tile, self.bw(lvl + 1))
            return torch.gather(coarse, 1, idx[..., None].expand(-1, -1, coarse.shape[-1]))

        latent = enc[5]
        up4 = self.decoder4(torch.cat([upsample(latent, 3), enc[4]], dim=-1))
        up3 = self.decoder3(torch.cat([upsample(up4, 2), enc[3]], dim=-1))
        up2 = self.decoder2(torch.cat([upsample(up3, 1), enc[2]], dim=-1))
        return [up2, up3, up4, latent]
