"""KPConv point branch, plain PyTorch: the banded radius and k-NN (tau)
formulations, as the port's model computes them with ``kernel='xla'``.
Module and parameter names follow the reference layout, so one state dict
loads into both."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.models.kernel_points import load_kernel_points
from benchmark.reference.models.layers import Linear, leaky_relu, norm_factory
from benchmark.reference.ops.banded import banded_knn_tau, banded_nearest_index, dynamic_band_starts, kernel_reach
from benchmark.reference.ops.plain import (
    banded_kpconv_fused_plain,
    banded_kpconv_fused_tau_plain,
    banded_maxpool_plain,
    banded_maxpool_tau_plain,
)

IMPLS = ("banded", "banded_knn")


class KPConv(nn.Module):
    """Rigid kernel-point convolution.

    forward(s_feats (B, N, Cin), q_points (B, M, 3), s_points (B, N, 3),
    starts, tau) -> (B, M, Cout) fp32: the aggregation + contraction,
    divided by the count, plus bias (kpconv.py:224-299).  Under
    ``impl='banded_knn'`` ``tau`` (B, M) is the pair's k-NN threshold
    (computed here over the static band when not given) and the layer's
    own ``kernel_points`` place the influence.
    """

    def __init__(self, in_channels, out_channels, kernel_size=15, radius=0.425, sigma=0.2,
                 dtype=torch.float32, tile=128, band_width=1024, impl="banded", knn_k=128):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        self.kernel_size, self.radius, self.sigma = kernel_size, radius, sigma
        self.dtype, self.tile, self.band_width = dtype, tile, band_width
        self.impl, self.knn_k = impl, knn_k
        bound = 1.0 / np.sqrt(in_channels * out_channels)
        self.weights = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound))
        kp = np.asarray(load_kernel_points(radius, kernel_size, 3), np.float32)
        self.register_buffer("kernel_points", torch.as_tensor(kp))

    def forward(self, s_feats, q_points, s_points, starts=None, tau=None):
        if self.impl == "banded_knn":
            if tau is None:
                tau = banded_knn_tau(q_points, s_points, self.knn_k, self.tile, self.band_width)
            args = (s_feats, q_points, s_points, self.weights, tau, self.kernel_points, self.radius, self.sigma,
                    self.kernel_size, self.tile, self.band_width, self.dtype, starts)
            plain = banded_kpconv_fused_tau_plain
        else:
            args = (s_feats, q_points, s_points, self.weights, self.radius, self.sigma,
                    self.kernel_size, self.tile, self.band_width, self.dtype, starts)
            plain = banded_kpconv_fused_plain
        out, count = plain(*args)
        return out / count[..., None].to(out.dtype) + self.bias


class UnaryBlock(nn.Module):
    """Linear -> norm -> LeakyReLU(0.1); ``norm=None`` leaves the plain
    Linear (the FPN's last decoder).  ``norm`` 'gn' or 'ln' as
    :func:`~benchmark.reference.models.layers.norm_factory` builds it."""

    def __init__(self, in_channels, out_channels, group_norm=32, has_relu=True, norm="gn", dtype=torch.float32):
        super().__init__()
        self.mlp = Linear(in_channels, out_channels, dtype=dtype)
        self.norm = norm_factory(norm, group_norm, out_channels) if norm else None
        self.has_relu = has_relu and norm is not None

    def forward(self, x):
        x = self.mlp(x)
        if self.norm is not None:
            x = self.norm(x)
        return leaky_relu(x) if self.has_relu else x


class ConvBlock(nn.Module):
    """KPConv -> norm -> LeakyReLU (reference modules.py:115-159)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm=32, norm="gn", **kw):
        super().__init__()
        self.KPConv = KPConv(in_channels, out_channels, kernel_size, radius, sigma, **kw)
        self.norm = norm_factory(norm, group_norm, out_channels)

    def forward(self, s_feats, q_points, s_points, starts=None, tau=None):
        return leaky_relu(self.norm(self.KPConv(s_feats, q_points, s_points, starts, tau)))


class ResidualBlock(nn.Module):
    """Bottleneck residual KPConv block; a strided block's shortcut is the
    banded maxpool of its input, over {d2 <= tau} under ``impl=
    'banded_knn'`` (reference modules.py:162-240; kpconv.py:539-661)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm=32,
                 strided=False, dtype=torch.float32, tile=128, band_width=1024, impl="banded", knn_k=128,
                 norm="gn"):
        super().__init__()
        mid = out_channels // 4
        self.strided, self.tile, self.band_width = strided, tile, band_width
        self.impl, self.knn_k = impl, knn_k
        self.r_active = kernel_reach(radius, sigma, kernel_size)
        self.unary1 = (
            UnaryBlock(in_channels, mid, group_norm, norm=norm, dtype=dtype) if in_channels != mid else None
        )
        self.KPConv = KPConv(mid, mid, kernel_size, radius, sigma, dtype=dtype, tile=tile,
                             band_width=band_width, impl=impl, knn_k=knn_k)
        self.norm_conv = norm_factory(norm, group_norm, mid)
        self.unary2 = UnaryBlock(mid, out_channels, group_norm, has_relu=False, norm=norm, dtype=dtype)
        self.unary_shortcut = (
            UnaryBlock(in_channels, out_channels, group_norm, has_relu=False, norm=norm, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, s_feats, q_points, s_points, starts=None, tau=None):
        x = s_feats if self.unary1 is None else self.unary1(s_feats)
        x = self.KPConv(x, q_points, s_points, starts, tau)
        x = self.unary2(leaky_relu(self.norm_conv(x)))
        if not self.strided:
            shortcut = s_feats
        elif self.impl == "banded_knn":
            if tau is None:
                tau = banded_knn_tau(q_points, s_points, self.knn_k, self.tile, self.band_width)
            shortcut = banded_maxpool_tau_plain(s_feats, q_points, s_points, tau, self.tile, self.band_width, starts)
        else:
            shortcut = banded_maxpool_plain(s_feats, q_points, s_points, self.r_active, self.tile, self.band_width,
                                            starts)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut)
        return leaky_relu(x + shortcut)


class KPConvFPN(nn.Module):
    """5-stage KPConv encoder + 3-step decoder over a Morton-ordered pyramid
    (reference kp_backbone.py:7-128).

    forward(feats (B, N0, input_dim), points [(B, N_l, 3)]) ->
    [fine (B, N1, output_dim), (B, N2, 512), (B, N3, 1024), latent (B, N4, 2048)].

    Under ``impl='banded'`` a radius pair reads its static band or, with a
    ``dynamic_plan`` width, each tile's dynamic window.  Under
    ``impl='banded_knn'`` each (query level, support level) pair gets one
    tau over the static band, shared by its blocks (``tau_for``,
    kpconv.py:855-876).
    """

    def __init__(self, input_dim=4, output_dim=64, init_dim=64, kernel_size=15, init_radius=0.425,
                 init_sigma=0.2, group_norm=32, dtype=torch.float32, tile=128, band_width=1024,
                 band_plan=None, dynamic_plan=None, dynamic_plan_self=None, dynamic_center="best",
                 impl="banded", knn_k=128, norm="gn"):
        super().__init__()
        d, ks, r, s = init_dim, kernel_size, init_radius, init_sigma
        self.tile, self.band_width, self.band_plan = tile, band_width, band_plan
        self.dynamic_plan, self.dynamic_plan_self = dynamic_plan, dynamic_plan_self
        self.dynamic_center, self.kernel_size, self.r, self.s = dynamic_center, ks, r, s
        self.impl, self.knn_k = impl, knn_k
        common = dict(group_norm=group_norm, dtype=dtype, tile=tile, impl=impl, knn_k=knn_k, norm=norm)

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
        self.decoder4 = UnaryBlock(d * 32 + d * 16, d * 16, group_norm, norm=norm, dtype=dtype)
        self.decoder3 = UnaryBlock(d * 16 + d * 8, d * 8, group_norm, norm=norm, dtype=dtype)
        self.decoder2 = UnaryBlock(d * 8 + d * 4, output_dim, norm=None, dtype=dtype)

    def bw(self, support_lvl: int) -> int:
        """Static half-band of a support level (kpconv.py:738-755)."""
        if self.band_plan is not None:
            if support_lvl < len(self.band_plan):
                return int(self.band_plan[support_lvl])
            return int(self.band_plan[-1]) * 2 ** (support_lvl - len(self.band_plan) + 1)
        return self.band_width * 2**support_lvl

    def dyn_w(self, support_lvl: int, is_self: bool) -> int:
        """Dynamic window width of a radius pair (0 = static band;
        kpconv.py:771-792)."""
        plan = self.dynamic_plan
        if is_self and self.dynamic_plan_self is not None:
            plan = self.dynamic_plan_self
        if plan is None or self.impl != "banded" or support_lvl >= len(plan):
            return 0
        return int(plan[support_lvl] or 0)

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

    def tau_for(self, q_pts, s_pts, support_lvl):
        """The pair's k-NN thresholds over the static band (kpconv.py:855-876)."""
        return banded_knn_tau(q_pts, s_pts, self.knn_k, self.tile, self.bw(support_lvl))

    def pair_aux(self, q_pts, s_pts, support_lvl, radius_scale, is_self):
        """(tau, starts) of a (query level, support level) pair under the
        impl (kpconv.py:840-846)."""
        if self.impl == "banded_knn":
            return self.tau_for(q_pts, s_pts, support_lvl), None
        return None, self.starts_for(q_pts, s_pts, support_lvl, radius_scale, is_self)

    def forward(self, feats, points):
        enc = {}
        tau0, st0 = self.pair_aux(points[0], points[0], 0, 1, True)
        x = self.encoder1_1(feats, points[0], points[0], st0, tau0)
        enc[1] = self.encoder1_2(x, points[0], points[0], st0, tau0)
        x = enc[1]
        for stage in range(2, 6):
            lvl = stage - 1
            tau_c, st_c = self.pair_aux(points[lvl], points[lvl - 1], lvl - 1, 2 ** (stage - 2), False)
            tau_s, st_s = self.pair_aux(points[lvl], points[lvl], lvl, 2 ** (stage - 1), True)
            x = getattr(self, f"encoder{stage}_1")(x, points[lvl], points[lvl - 1], st_c, tau_c)
            for i in (2, 3):
                x = getattr(self, f"encoder{stage}_{i}")(x, points[lvl], points[lvl], st_s, tau_s)
            enc[stage] = x

        def upsample(coarse, lvl):
            idx = banded_nearest_index(points[lvl], points[lvl + 1], self.tile, self.bw(lvl + 1))
            return torch.gather(coarse, 1, idx[..., None].expand(-1, -1, coarse.shape[-1]))

        latent = enc[5]
        up4 = self.decoder4(torch.cat([upsample(latent, 3), enc[4]], dim=-1))
        up3 = self.decoder3(torch.cat([upsample(up4, 2), enc[3]], dim=-1))
        up2 = self.decoder2(torch.cat([upsample(up3, 1), enc[2]], dim=-1))
        return [up2, up3, up4, latent]
