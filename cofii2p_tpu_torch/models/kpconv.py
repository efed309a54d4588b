"""KPConv point branch (counterpart of cofii2p_tpu/models/kpconv.py) in
its three formulations: ``impl='banded'`` and ``'banded_knn'`` over
banded neighbourhoods, and ``'gather'`` over the pyramid's k-NN index
maps.

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

``residual_fused`` (``config.kpconv_residual_fused``): a strided block
passes its input to its KPConv as ``mp_feats``, and where
``residual_fused_fits`` admits the shapes the KPConv runs
ops/residual_kernel.py::banded_residual_apply, which returns the shortcut
maxpool beside the conv from one band pass (kernel #16; all four strided
blocks in bf16 serving, encoder2_1..4_1 on the fp32 static plan);
differentiated, the unfused pair runs, as in the JAX package.

``impl='gather'`` is the JAX package's exact k-NN formulation
(kpconv.py:415-456): each KPConv gathers the features of its queries'
``neighbor_num`` nearest support points through the pyramid's maps,
weighs them by the kernel points' influence (:func:`kernel_influence`,
shared by the blocks of a level when ``shared_influence`` is on) and
divides by the reference's count of "active" neighbours, those whose
gathered features sum to more than zero; a strided shortcut is the max
over the ``subsampling`` neighbours (:func:`neighbor_maxpool`) and the
decoder copies each fine point's nearest coarse feature
(:func:`nearest_upsample`).  It is plain PyTorch: the JAX package reaches
no Pallas kernel on it either.

``impl='banded_knn'`` is the k-NN semantics a reference checkpoint was
trained with: per (query level, support level) pair one threshold tau per
query (ops/tau_kernel.py, kernel #5) decides membership d2 <= tau, every
KPConv uses its own ``kernel_points`` buffer (kernels #6, #7) and the
strided shortcuts max over {d2 <= tau} with no radius mask (kernel #8).
Differentiated, they go through ``BandedKPConvTauFn`` and
``BandedMaxpoolTauFn``, whose backwards are kernels #11, #12 (tau mode)
and #15; the kernel points stay frozen buffers.  A k-NN window plan
(``knn_window_plan``) is forward-only and raises when differentiated, as
in the JAX package.

The compacted formulations (``maxpool_compact_plan``,
``aggregate_compact_plan``, per support level; kpconv.py:179-215, 576-600,
908-920) replace a banded KPConv's aggregation, or a strided block's
shortcut maxpool, by one over each query's k nearest band rows
(ops/banded.py::banded_compact_aggregate, banded_compact_maxpool): plain
PyTorch, as the JAX package runs them in XLA.  Under 'banded_knn' the cap
is ``knn_k`` and the plan value only selects the formulation.  Each (query
level, support level) pair with a compacted consumer computes one
nearest-first selection (``rel_for``) that every such consumer slices; a
k-NN pair whose consumers are all compacted computes no tau.  Under
'gather' the plans are ignored, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cofii2p_tpu_torch.models.kernel_points import load_kernel_points
from cofii2p_tpu_torch.models.layers import GroupNormWrapper, Linear, leaky_relu, norm_factory
from cofii2p_tpu_torch.ops.banded import (
    _round,
    band_plan,
    banded_compact_aggregate,
    banded_compact_maxpool,
    banded_knn_select,
    banded_knn_tau,
    banded_nearest_index,
    dynamic_band_starts,
    dynamic_knn_starts,
    kernel_reach,
)
from cofii2p_tpu_torch.ops.geometry import fma_dot, gather_neighbors
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    banded_kpconv_apply,
    banded_kpconv_fused_plain,
    banded_kpconv_fused_tau_plain,
    banded_kpconv_tau_apply,
    fused_contraction_fits,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import (
    banded_maxpool_apply,
    banded_maxpool_plain,
    banded_maxpool_tau_apply,
    banded_maxpool_tau_plain,
)
from cofii2p_tpu_torch.ops.residual_kernel import banded_residual_apply, residual_fused_fits
from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_kernel

KERNELS = ("auto", "pallas", "xla")
IMPLS = ("gather", "banded", "banded_knn")


class NeighborMaxpoolFn(torch.autograd.Function):
    """Max over gathered neighbour rows whose backward splits each output's
    gradient evenly among the rows tied at the max, as JAX differentiates
    ``jnp.max``, and keeps only the output: the (B, M, H, C) gather is
    taken again in the backward rather than held."""

    @staticmethod
    def forward(ctx, feats, neighbor_indices):
        out = gather_neighbors(feats, neighbor_indices).amax(-2)
        ctx.save_for_backward(feats, neighbor_indices, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        feats, idx, out = ctx.saved_tensors
        b, n, c = feats.shape
        tied = gather_neighbors(feats, idx) == out[..., None, :]  # (B, M, H, C)
        share = grad.float() / tied.sum(-2).float()
        contrib = torch.where(tied, share[..., None, :], 0.0).reshape(b, -1, c)
        rows = (idx.long() + (n + 1) * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
        g = torch.zeros(b * (n + 1), c, dtype=torch.float32, device=grad.device)
        g.index_add_(0, rows, contrib.reshape(-1, c))  # index n: the shadow row, dropped
        return g.reshape(b, n + 1, c)[:, :n].to(feats.dtype), None


def neighbor_maxpool(feats: torch.Tensor, neighbor_indices: torch.Tensor) -> torch.Tensor:
    """Max over the features of each query's neighbours, shadow rows (index
    N) counting as zeros: feats (B, N, C), neighbor_indices (B, M, H) ->
    (B, M, C) (kpconv.py:43-47)."""
    return NeighborMaxpoolFn.apply(feats, neighbor_indices)


def nearest_upsample(feats: torch.Tensor, upsample_indices: torch.Tensor) -> torch.Tensor:
    """Each fine point takes the coarse feature of its nearest coarse point,
    column 0 of the upsampling map: feats (B, M, C), upsample_indices
    (B, N, k) -> (B, N, C) (kpconv.py:50-56)."""
    idx = upsample_indices[..., 0].long()
    return torch.gather(feats, -2, idx[..., None].expand(*idx.shape, feats.shape[-1]))


def kernel_influence(q_points, s_points, neighbor_indices, radius, sigma, kernel_size=15, kp=None):
    """Linear-correlation influence max(1 - |offset - kp_k| / sigma, 0) of
    each kernel point on each gathered neighbour, zero for shadow rows:
    (B, M, H, K) fp32 (kpconv.py:59-94).  ``kp`` (K, 3): a layer's own
    kernel points; None takes the canonical disposition at ``radius``.
    The squared distances come by the matmul identity with every sum of
    three products a fused chain (ops/geometry.py::fma_dot), the
    arithmetic of the jitted JAX function, and no matmul (so no TF32)."""
    n = s_points.shape[-2]
    if kp is None:
        kp = torch.as_tensor(np.asarray(load_kernel_points(radius, kernel_size, 3), np.float32))
    kp = kp.to(device=q_points.device, dtype=torch.float32)
    offsets = gather_neighbors(s_points, neighbor_indices) - q_points[..., None, :]  # (B, M, H, 3)
    cross = fma_dot(offsets[..., None, :], kp)  # (B, M, H, K)
    sq = (fma_dot(offsets, offsets)[..., None] + fma_dot(kp, kp)) - 2.0 * cross
    influence = torch.clamp(1.0 - torch.sqrt(torch.clamp(sq, min=0.0)) / sigma, min=0.0)
    return torch.where((neighbor_indices < n)[..., None], influence, 0.0)


def knn_tau(kernel, q_points, s_points, k, tile, band_width, starts=None):
    """Per-query k-NN thresholds (B, M): kernel #5, or its plain version
    under ``kernel='xla'``."""
    fn = banded_knn_tau if kernel == "xla" else banded_knn_tau_kernel
    return fn(q_points, s_points, k, tile, band_width, starts)


class KPConv(nn.Module):
    """Rigid kernel-point convolution.

    forward(s_feats (B, N, Cin), q_points (B, M, 3), s_points (B, N, 3),
    starts, tau) -> (B, M, Cout) fp32: the aggregation + contraction,
    divided by the count, plus bias (kpconv.py:224-299, 355-382).  Under
    ``impl='gather'`` it takes ``neighbor_indices`` (B, M, H), N meaning
    no neighbour, and optionally a shared ``influence`` (B, M, H, K)
    (kpconv.py:415-456).  Under
    ``impl='banded_knn'`` ``tau`` (B, M) is the pair's k-NN threshold
    (computed here over the static band when not given) and the layer's
    own ``kernel_points`` place the influence.  With ``mp_feats`` (a
    strided block's input, banded impl, kernels) it returns (out,
    shortcut): the maxpool of ``mp_feats`` from the fused band pass where
    ``residual_fused_fits``, else None (kpconv.py:312-353).
    ``aggregate_compact`` k > 0 (banded impls): the compacted aggregation
    over each query's k nearest band rows (``knn_k`` under 'banded_knn'),
    sliced from ``rel`` (B, M, >= k), the pair's shared selection, when
    given (kpconv.py:179-215).
    """

    def __init__(self, in_channels, out_channels, kernel_size=15, radius=0.425, sigma=0.2,
                 dtype=torch.float32, tile=128, band_width=1024, kernel="auto", impl="banded", knn_k=128,
                 aggregate_compact=0):
        super().__init__()
        if kernel not in KERNELS:
            raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        self.kernel_size, self.radius, self.sigma = kernel_size, radius, sigma
        self.dtype, self.tile, self.band_width, self.kernel = dtype, tile, band_width, kernel
        self.impl, self.knn_k = impl, knn_k
        self.aggregate_compact = aggregate_compact if impl != "gather" else 0
        bound = 1.0 / np.sqrt(in_channels * out_channels)
        self.weights = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound))
        kp = np.asarray(load_kernel_points(radius, kernel_size, 3), np.float32)
        self.register_buffer("kernel_points", torch.as_tensor(kp))
        self.wbytes = torch.empty((), dtype=dtype).element_size()
        self.fused = fused_contraction_fits(kernel_size, in_channels, out_channels, tile, wbytes=self.wbytes)

    def forward(self, s_feats, q_points, s_points, starts=None, tau=None, mp_feats=None, neighbor_indices=None,
                influence=None, rel=None):
        if self.impl == "gather":
            return self._gather(s_feats, q_points, s_points, neighbor_indices, influence)
        if self.aggregate_compact:
            return self._compact(s_feats, q_points, s_points, rel)
        if mp_feats is not None:
            return self._residual(s_feats, q_points, s_points, starts, mp_feats)
        if self.impl == "banded_knn":
            if tau is None:
                tau = knn_tau(self.kernel, q_points, s_points, self.knn_k, self.tile, self.band_width)
            args = (s_feats, q_points, s_points, self.weights, tau, self.kernel_points, self.radius, self.sigma,
                    self.kernel_size, self.tile, self.band_width, self.dtype, starts)
            plain, apply = banded_kpconv_fused_tau_plain, banded_kpconv_tau_apply
        else:
            args = (s_feats, q_points, s_points, self.weights, self.radius, self.sigma,
                    self.kernel_size, self.tile, self.band_width, self.dtype, starts)
            plain, apply = banded_kpconv_fused_plain, banded_kpconv_apply
        out, count = plain(*args) if self.kernel == "xla" else apply(*args, fused=self.fused)
        return out / count[..., None].to(out.dtype) + self.bias

    def _compact(self, s_feats, q_points, s_points, rel):
        """The compacted aggregation, then the contraction with the bf16 (or
        fp32) weights in fp32, divided by the count: k-NN mode passes the
        layer's own kernel points, radius mode the canonical ones, whose
        exact reach the in-reach count needs (kpconv.py:179-215)."""
        knn = self.impl == "banded_knn"
        kk = self.knn_k if knn else self.aggregate_compact
        weighted, count = banded_compact_aggregate(
            s_feats, q_points, s_points, self.radius, self.sigma, self.kernel_size, kk, self.tile, self.band_width,
            self.dtype, knn=knn, kp=self.kernel_points if knn else None,
            rel=None if rel is None else rel[..., :kk],
        )
        b, m, k, c = weighted.shape
        out = _round(weighted, self.dtype).reshape(b, m, k * c) @ _round(self.weights, self.dtype).reshape(k * c, -1)
        return out / count[..., None].to(out.dtype) + self.bias

    def _gather(self, s_feats, q_points, s_points, neighbor_indices, influence):
        """The gather formulation: both products at JAX's rounding points
        (bf16 operands, fp32 accumulation and output), and the reference's
        count of neighbours whose gathered features sum to more than zero
        (kpconv.py:440-445)."""
        dt = self.dtype
        if influence is None:
            influence = kernel_influence(q_points, s_points, neighbor_indices, self.radius, self.sigma,
                                         self.kernel_size, kp=self.kernel_points)
        nbr_feats = gather_neighbors(s_feats.to(dt), neighbor_indices)  # (B, M, H, C)
        weighted = torch.matmul(influence.to(dt).transpose(-1, -2), nbr_feats)  # (B, M, K, C)
        b, m, k, c = weighted.shape
        # a product of two bf16 values is exact in fp32: this is the bf16
        # contraction with fp32 accumulation
        out = weighted.float().reshape(b, m, k * c) @ self.weights.to(dt).float().reshape(k * c, -1)
        with torch.no_grad():
            count = torch.clamp((nbr_feats.sum(-1) > 0).sum(-1), min=1)
        return out / count[..., None].to(out.dtype) + self.bias

    def _residual(self, s_feats, q_points, s_points, starts, mp_feats):
        band = band_plan(q_points.shape[1], s_points.shape[1], self.tile, self.band_width, starts)[2]
        cin, cout = self.weights.shape[1:]
        if not (self.fused and residual_fused_fits(self.kernel_size, cin, cout, mp_feats.shape[-1], band, self.tile,
                                                   self.wbytes, mp_feats.element_size())):
            return self.forward(s_feats, q_points, s_points, starts), None
        out, count, shortcut = banded_residual_apply(
            mp_feats, s_feats, self.weights, q_points, s_points, self.radius, self.sigma, self.kernel_size,
            self.tile, self.band_width, self.dtype, starts,
        )
        return out / count[..., None].to(out.dtype) + self.bias, shortcut


class UnaryBlock(nn.Module):
    """Linear -> norm -> LeakyReLU(0.1); ``norm=None`` leaves the plain
    Linear (the FPN's last decoder).  ``norm`` 'gn' or 'ln' as
    :func:`~cofii2p_tpu_torch.models.layers.norm_factory` builds it."""

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

    def forward(self, s_feats, q_points, s_points, starts=None, tau=None, neighbor_indices=None, influence=None,
                rel=None):
        x = self.KPConv(s_feats, q_points, s_points, starts, tau, neighbor_indices=neighbor_indices,
                        influence=influence, rel=rel)
        return leaky_relu(self.norm(x))


class ResidualBlock(nn.Module):
    """Bottleneck residual KPConv block; a strided block's shortcut is the
    banded maxpool of its input, over {d2 <= tau} under ``impl=
    'banded_knn'``, over the ``subsampling`` neighbours under 'gather'
    (reference modules.py:162-240; kpconv.py:539-661).
    ``residual_fused`` requests the fused band pass, which a strided banded
    block on the kernels takes unless it takes a compacted formulation
    (kpconv.py:543-554).  ``maxpool_compact`` k > 0 (banded impls): the
    shortcut is the compacted maxpool over each query's k nearest band rows
    within reach, or under 'banded_knn' over the ``knn_k`` nearest with no
    radius mask (kpconv.py:576-600)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm=32,
                 strided=False, dtype=torch.float32, tile=128, band_width=1024, kernel="auto",
                 impl="banded", knn_k=128, residual_fused=False, norm="gn", maxpool_compact=0,
                 aggregate_compact=0):
        super().__init__()
        mid = out_channels // 4
        self.strided, self.tile, self.band_width, self.kernel = strided, tile, band_width, kernel
        self.impl, self.knn_k = impl, knn_k
        self.maxpool_compact = maxpool_compact if impl != "gather" else 0
        self.residual_fused = (residual_fused and strided and impl == "banded" and kernel != "xla"
                               and not maxpool_compact and not aggregate_compact)
        self.r_active = kernel_reach(radius, sigma, kernel_size)
        self.unary1 = (
            UnaryBlock(in_channels, mid, group_norm, norm=norm, dtype=dtype) if in_channels != mid else None
        )
        self.KPConv = KPConv(mid, mid, kernel_size, radius, sigma, dtype=dtype, tile=tile,
                             band_width=band_width, kernel=kernel, impl=impl, knn_k=knn_k,
                             aggregate_compact=aggregate_compact)
        self.norm_conv = norm_factory(norm, group_norm, mid)
        self.unary2 = UnaryBlock(mid, out_channels, group_norm, has_relu=False, norm=norm, dtype=dtype)
        self.unary_shortcut = (
            UnaryBlock(in_channels, out_channels, group_norm, has_relu=False, norm=norm, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, s_feats, q_points, s_points, starts=None, tau=None, neighbor_indices=None, influence=None,
                rel=None):
        x = s_feats if self.unary1 is None else self.unary1(s_feats)
        shortcut = None
        if self.residual_fused:
            x, shortcut = self.KPConv(x, q_points, s_points, starts, tau, mp_feats=s_feats)
        else:
            x = self.KPConv(x, q_points, s_points, starts, tau, neighbor_indices=neighbor_indices,
                            influence=influence, rel=rel)
        x = self.unary2(leaky_relu(self.norm_conv(x)))
        if not self.strided:
            shortcut = s_feats
        elif shortcut is None:  # not from the fused band pass
            if self.maxpool_compact:
                knn = self.impl == "banded_knn"
                k = self.knn_k if knn else self.maxpool_compact
                shortcut = banded_compact_maxpool(
                    s_feats, q_points, s_points, 0.0 if knn else self.r_active, k, self.tile, self.band_width,
                    knn=knn, rel=None if rel is None else rel[..., :k],
                )
            elif self.impl == "gather":
                shortcut = neighbor_maxpool(s_feats, neighbor_indices)
            elif self.impl == "banded_knn":
                if tau is None:
                    tau = knn_tau(self.kernel, q_points, s_points, self.knn_k, self.tile, self.band_width)
                fn = banded_maxpool_tau_plain if self.kernel == "xla" else banded_maxpool_tau_apply
                shortcut = fn(s_feats, q_points, s_points, tau, self.tile, self.band_width, starts)
            else:
                fn = banded_maxpool_plain if self.kernel == "xla" else banded_maxpool_apply
                shortcut = fn(s_feats, q_points, s_points, self.r_active, self.tile, self.band_width, starts)
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
            if isinstance(norm, GroupNormWrapper) and norm.norm.num_groups == norm.norm.weight.numel():
                names.append(f"{prefix}.{name}" if prefix else name)
    return names


class KPConvFPN(nn.Module):
    """5-stage KPConv encoder + 3-step decoder over a Morton-ordered pyramid
    (reference kp_backbone.py:7-128).

    forward(feats (B, N0, input_dim), points [(B, N_l, 3)]) ->
    [fine (B, N1, output_dim), (B, N2, 512), (B, N3, 1024), latent (B, N4, 2048)].

    Under ``impl='banded_knn'`` each (query level, support level) pair gets
    one tau, shared by its blocks (``tau_for``, kpconv.py:855-876), over the
    static band or, with a ``knn_window_plan`` width, over each tile's
    max-in-tau-mass window (``knn_tau_starts``, kpconv.py:878-906).

    Under ``impl='gather'`` forward also takes the pyramid's maps
    ``neighbors``, ``subsampling`` and ``upsampling`` (ops/pyramid.py).
    With ``shared_influence`` one :func:`kernel_influence` of the canonical
    kernel points per level serves the level's self blocks, and a strided
    block's KPConv computes its own from its own kernel points
    (kpconv.py:923-1003); without it every KPConv computes its own, as a
    reference checkpoint's per-layer kernel points need.  The banded paths
    always compute influence per layer from its own kernel points.

    ``maxpool_compact_plan`` / ``aggregate_compact_plan`` (per support
    level, 0 or None = the band formulation): the compacted strided
    shortcuts and KPConvs (banded impls; kpconv.py:757-769); each pair with
    a compacted consumer gets one shared selection (``rel_for``,
    kpconv.py:908-920).  A dynamic or k-NN window on a support level that
    also takes a compacted formulation raises NotImplementedError.
    """

    def __init__(self, input_dim=4, output_dim=64, init_dim=64, kernel_size=15, init_radius=0.425,
                 init_sigma=0.2, group_norm=32, dtype=torch.float32, tile=128, band_width=1024,
                 band_plan=None, kernel="auto", dynamic_plan=None, dynamic_plan_self=None,
                 dynamic_center="best", impl="banded", knn_k=128, knn_window_plan=None,
                 shared_influence=True, residual_fused=False, norm="gn", maxpool_compact_plan=None,
                 aggregate_compact_plan=None):
        super().__init__()
        d, ks, r, s = init_dim, kernel_size, init_radius, init_sigma
        self.tile, self.band_width, self.band_plan = tile, band_width, band_plan
        self.dynamic_plan, self.dynamic_plan_self = dynamic_plan, dynamic_plan_self
        self.dynamic_center, self.kernel_size, self.r, self.s = dynamic_center, ks, r, s
        self.impl, self.knn_k, self.knn_window_plan = impl, knn_k, knn_window_plan
        self.kernel, self.shared_influence = kernel, shared_influence
        self.maxpool_compact_plan, self.aggregate_compact_plan = maxpool_compact_plan, aggregate_compact_plan
        common = dict(group_norm=group_norm, dtype=dtype, tile=tile, kernel=kernel, impl=impl, knn_k=knn_k, norm=norm)

        self.encoder1_1 = ConvBlock(input_dim, d, ks, r, s, band_width=self._bw_for(0, True),
                                    aggregate_compact=self.agg_compact(0), **common)
        self.encoder1_2 = ResidualBlock(d, d * 2, ks, r, s, band_width=self._bw_for(0, True),
                                        aggregate_compact=self.agg_compact(0), **common)
        for stage, cin, cout in ((2, d * 2, d * 4), (3, d * 4, d * 8), (4, d * 8, d * 16), (5, d * 16, d * 32)):
            lvl = stage - 1
            rs, rc = r * 2 ** (stage - 2), r * 2 ** (stage - 1)
            ss, sc = s * 2 ** (stage - 2), s * 2 ** (stage - 1)
            setattr(self, f"encoder{stage}_1", ResidualBlock(
                cin, cin, ks, rs, ss, strided=True, band_width=self._bw_for(lvl - 1, False),
                residual_fused=residual_fused, maxpool_compact=self.mp_compact(lvl - 1),
                aggregate_compact=self.agg_compact(lvl - 1), **common))
            setattr(self, f"encoder{stage}_2", ResidualBlock(
                cin, cout, ks, rc, sc, band_width=self._bw_for(lvl, True), aggregate_compact=self.agg_compact(lvl),
                **common))
            setattr(self, f"encoder{stage}_3", ResidualBlock(
                cout, cout, ks, rc, sc, band_width=self._bw_for(lvl, True), aggregate_compact=self.agg_compact(lvl),
                **common))
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

    @staticmethod
    def _plan_at(plan, support_lvl: int) -> int:
        return int(plan[support_lvl] or 0) if plan is not None and support_lvl < len(plan) else 0

    def mp_compact(self, support_lvl: int) -> int:
        """Compacted shortcut maxpool k of a support level (0 = the band
        formulation; kpconv.py:757-762); the plan is ignored under 'gather'."""
        return self._plan_at(self.maxpool_compact_plan, support_lvl) if self.impl != "gather" else 0

    def agg_compact(self, support_lvl: int) -> int:
        """Compacted KPConv aggregation k of a support level (0 = the band
        formulation; kpconv.py:764-769); the plan is ignored under 'gather'."""
        return self._plan_at(self.aggregate_compact_plan, support_lvl) if self.impl != "gather" else 0

    def _refuse_window(self, plan_name: str, support_lvl: int) -> None:
        # the compacted branches take no starts and would read the window
        # width as the static half-band: a quiet change of geometry
        if self.mp_compact(support_lvl) or self.agg_compact(support_lvl):
            raise NotImplementedError(
                f"{plan_name} cannot be combined with maxpool_compact_plan/aggregate_compact_plan on the same "
                f"support level ({support_lvl}): the compacted branches ignore dynamic starts"
            )

    def dyn_w(self, support_lvl: int, is_self: bool) -> int:
        """Dynamic window width of a radius pair (0 = static band;
        kpconv.py:771-792); raises where the level takes a compacted
        formulation."""
        plan = self.dynamic_plan
        if is_self and self.dynamic_plan_self is not None:
            plan = self.dynamic_plan_self
        if plan is None or self.impl != "banded":
            return 0
        w = self._plan_at(plan, support_lvl)
        if w:
            self._refuse_window("kpconv_dynamic_plan", support_lvl)
        return w

    def knn_w(self, support_lvl: int) -> int:
        """k-NN window width of a pair under ``impl='banded_knn'`` (0 =
        static band; kpconv.py:794-801).  Unlike the JAX package's, it raises
        where the level takes a compacted formulation, as :meth:`dyn_w`
        does."""
        if self.impl != "banded_knn":
            return 0
        w = self._plan_at(self.knn_window_plan, support_lvl)
        if w:
            self._refuse_window("kpconv_knn_window_plan", support_lvl)
        return w

    def _bw_for(self, support_lvl: int, is_self: bool) -> int:
        return self.dyn_w(support_lvl, is_self) or self.knn_w(support_lvl) or self.bw(support_lvl)

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
        return knn_tau(self.kernel, q_pts, s_pts, self.knn_k, self.tile, self.bw(support_lvl))

    def knn_tau_starts(self, q_pts, s_pts, support_lvl):
        """(tau, starts) of a k-NN pair (kpconv.py:878-906).  With a window
        width W: a proxy tau on every stride-th support row places each
        tile's max-in-tau-mass window, then tau is taken exactly over it."""
        w = self.knn_w(support_lvl)
        if w == 0:
            return self.tau_for(q_pts, s_pts, support_lvl), None
        k = self.knn_k
        stride = max(1, s_pts.shape[-2] // 2560)
        proxy = knn_tau(self.kernel, q_pts, s_pts[:, ::stride].contiguous(), max(k // stride, 1), self.tile,
                        max(self.bw(support_lvl) // stride, 32))
        starts = dynamic_knn_starts(q_pts, s_pts, proxy, self.tile, w, stride)
        return knn_tau(self.kernel, q_pts, s_pts, k, self.tile, w, starts), starts

    def pair_aux(self, q_pts, s_pts, support_lvl, radius_scale, is_self):
        """(tau, starts) of a (query level, support level) pair under the
        impl (kpconv.py:840-846).  A k-NN pair whose consumers (its
        KPConvs and, on a cross pair, the strided shortcut) all take a
        compacted formulation gets no tau: nothing would read it."""
        if self.impl == "banded_knn":
            compacted = self.agg_compact(support_lvl) and (is_self or self.mp_compact(support_lvl))
            if compacted:
                return None, None
            return self.knn_tau_starts(q_pts, s_pts, support_lvl)
        return None, self.starts_for(q_pts, s_pts, support_lvl, radius_scale, is_self)

    def rel_for(self, q_pts, s_pts, support_lvl, agg_k, mp_k=0):
        """One nearest-first selection per (query level, support level) pair
        with a compacted consumer, shared by all of them: the KPConvs slice
        its first agg_k columns, the shortcut its first mp_k; taken at
        ``knn_k`` under 'banded_knn', else at the largest k (kpconv.py:
        908-920).  None where no consumer is compacted."""
        ks = [k for k in (agg_k, mp_k) if k > 0]
        if not ks:
            return None
        kmax = self.knn_k if self.impl == "banded_knn" else max(ks)
        return banded_knn_select(q_pts, s_pts, kmax, self.tile, self.bw(support_lvl))

    def influence_for(self, q_pts, s_pts, nbr, radius_scale):
        """A level's shared influence of the canonical kernel points, or None
        (each KPConv then computes its own; kpconv.py:924-958)."""
        if self.impl != "gather" or not self.shared_influence:
            return None
        return kernel_influence(q_pts, s_pts, nbr, self.r * radius_scale, self.s * radius_scale, self.kernel_size)

    def forward(self, feats, points, neighbors=None, subsampling=None, upsampling=None):
        gather = self.impl == "gather"
        enc = {}
        nbr0 = neighbors[0] if gather else None
        inf0 = self.influence_for(points[0], points[0], nbr0, 1)
        rel0 = self.rel_for(points[0], points[0], 0, self.agg_compact(0))
        tau0, st0 = self.pair_aux(points[0], points[0], 0, 1, True)
        x = self.encoder1_1(feats, points[0], points[0], st0, tau0, neighbor_indices=nbr0, influence=inf0, rel=rel0)
        enc[1] = self.encoder1_2(x, points[0], points[0], st0, tau0, neighbor_indices=nbr0, influence=inf0,
                                 rel=rel0)
        x = enc[1]
        for stage in range(2, 6):
            lvl = stage - 1
            nbr = neighbors[lvl] if gather else None
            sub = subsampling[lvl - 1] if gather else None
            inf_s = self.influence_for(points[lvl], points[lvl], nbr, 2 ** (stage - 1))
            rel_c = self.rel_for(points[lvl], points[lvl - 1], lvl - 1, self.agg_compact(lvl - 1),
                                 self.mp_compact(lvl - 1))
            rel_s = self.rel_for(points[lvl], points[lvl], lvl, self.agg_compact(lvl))
            tau_c, st_c = self.pair_aux(points[lvl], points[lvl - 1], lvl - 1, 2 ** (stage - 2), False)
            tau_s, st_s = self.pair_aux(points[lvl], points[lvl], lvl, 2 ** (stage - 1), True)
            # the gather maps go by keyword: a block's positional arguments
            # stay (feats, q, s, starts, tau) on every path
            strided = getattr(self, f"encoder{stage}_1")
            x = strided(x, points[lvl], points[lvl - 1], st_c, tau_c, neighbor_indices=sub, rel=rel_c)
            for i in (2, 3):
                x = getattr(self, f"encoder{stage}_{i}")(x, points[lvl], points[lvl], st_s, tau_s,
                                                         neighbor_indices=nbr, influence=inf_s, rel=rel_s)
            enc[stage] = x

        def upsample(coarse, lvl):
            if gather:
                return nearest_upsample(coarse, upsampling[lvl])
            idx = banded_nearest_index(points[lvl], points[lvl + 1], self.tile, self.bw(lvl + 1))
            return torch.gather(coarse, 1, idx[..., None].expand(-1, -1, coarse.shape[-1]))

        latent = enc[5]
        up4 = self.decoder4(torch.cat([upsample(latent, 3), enc[4]], dim=-1))
        up3 = self.decoder3(torch.cat([upsample(up4, 2), enc[3]], dim=-1))
        up2 = self.decoder2(torch.cat([upsample(up3, 1), enc[2]], dim=-1))
        return [up2, up3, up4, latent]
