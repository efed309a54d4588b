"""Banded maxpool: the CUDA kernels' wrappers, their plain versions and the
autograd Function that differentiates through them.

Counterpart of cofii2p_tpu/ops/maxpool_kernel.py.  Six kernels:
 - :func:`banded_maxpool_fused` (csrc/maxpool_fwd.cu; replaces
   banded_maxpool_pallas): a block a 128-query tile and every channel,
   membership tested once a tile and kept as bits, the rows any query
   holds staged once per channel slice in shared memory and maxed there
   per query (plan: csrc/maxpool_plan.cuh);
 - :func:`banded_maxpool_tie_count_fused` (csrc/maxpool_fwd.cu in COUNT
   mode: the forward's block, membership and staging, a comparison with
   the forward max in place of the max; replaces _match_count) counts the
   member rows tied at the max, on static bands or dynamic windows, by
   radius or by tau;
 - :func:`banded_maxpool_backward_fused` (csrc/maxpool_route.cu with
   radius membership; replaces _bwd) routes the tie-divided cotangent to
   those rows on static bands: a block 64 support rows and every channel,
   membership once a block as a 64-bit word a window query, the listed
   queries' out and gs staged once per channel slice (plan:
   csrc/maxpool_plan.cuh); :func:`banded_maxpool_backward_dyn_fused` (the
   same kernel in window mode, a block 64 rows of one tile's window, then
   csrc/band_scatter.cu; replaces _bwd_dyn) on dynamic windows;
 - :func:`banded_maxpool_tau` (csrc/maxpool_fwd.cu with tau thresholds;
   replaces banded_maxpool_tau_pallas) is the reference's k-NN maxpool:
   membership d2 <= tau[m], no radius mask;
   :func:`banded_maxpool_backward_tau_fused` (csrc/maxpool_route.cu with
   tau membership; replaces _tau_bwd) its routing.

Each wrapper takes its plain version (ops/banded.py) for a CPU tensor and
launches its kernel for a CUDA tensor; there is no other fallback.
Differentiation goes through :class:`BandedMaxpoolFn` and
:class:`BandedMaxpoolTauFn` (:func:`banded_maxpool_apply` and
:func:`banded_maxpool_tau_apply` pick the path).
"""

from __future__ import annotations

import numpy as np
import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import (
    _band_geometry,
    band_plan,
    banded_maxpool,
    banded_maxpool_route,
    banded_maxpool_tie_count,
    static_starts,
)
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    _check_cuda,
    _starts_arg,
    _transpose_plan,
    band_scatter,
    check_no_grad,
    pick_tq,
)

ROUTE_TS = 64  # support rows per block of the routings #13, #14, #15 (RoutePlan::TS, csrc/maxpool_plan.cuh)

banded_maxpool_plain = banded_maxpool


banded_maxpool_tie_count_plain = banded_maxpool_tie_count
banded_maxpool_route_plain = banded_maxpool_route


def banded_maxpool_tau_plain(s_feats, q_points, s_points, tau, tile=128, band_width=1024, starts=None):
    """Plain version of :func:`banded_maxpool_tau`."""
    return banded_maxpool(s_feats, q_points, s_points, 0.0, tile, band_width, starts, tau=tau)


def banded_maxpool_route_dyn_plain(g_scaled, s_feats, q_points, s_points, out, starts, r_active, tile=128,
                                   band_width=256):
    """Plain version of :func:`banded_maxpool_backward_dyn_fused`."""
    return banded_maxpool_route(g_scaled, s_feats, q_points, s_points, out, r_active, tile, band_width, starts)


def banded_maxpool_route_tau_plain(g_scaled, s_feats, q_points, s_points, out, tau, tile=128, band_width=1024):
    """Plain version of :func:`banded_maxpool_backward_tau_fused`."""
    return banded_maxpool_route(g_scaled, s_feats, q_points, s_points, out, 0.0, tile, band_width, tau=tau)


def banded_maxpool_fused(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
    """Max over in-reach band features; 0 where none is in reach.

    s_feats (B, N, C) fp32 or bf16, q_points (B, M, 3), s_points (B, N, 3)
    fp32, optional dynamic ``starts`` (B, num_tiles).  Returns (B, M, C) in
    the dtype of ``s_feats``.
    """
    if s_feats.device.type == "cpu":
        return banded_maxpool_plain(s_feats, q_points, s_points, r_active, tile, band_width, starts)
    check_no_grad("banded_maxpool_fused", s_feats, function="BandedMaxpoolFn")
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    if s_feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feature dtype {s_feats.dtype} not supported")
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if s_points.shape[:2] != (b, n):
        raise ValueError("shape mismatch between features and points")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, s_feats.device, starts)
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points, starts=st)
    out = torch.empty(b, m, c, dtype=s_feats.dtype, device=s_feats.device)
    err = cuda_lib.lib().maxpool_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), st.data_ptr(), out.data_ptr(),
        b, m, n, c, tile, band, float(np.float32(r_active * r_active)), cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "maxpool")
    banded_maxpool_fused.launches += 1
    return out


banded_maxpool_fused.launches = 0


def banded_maxpool_tau(s_feats, q_points, s_points, tau, tile=128, band_width=1024, starts=None):
    """The k-NN maxpool (kernel #8): the max of s_feats over the band rows
    with d2 <= tau[m], 0 where there is none.  tau (B, M) fp32 from
    ops/tau_kernel.py; other arguments as :func:`banded_maxpool_fused`.
    Returns (B, M, C) in the dtype of ``s_feats``."""
    if s_feats.device.type == "cpu":
        return banded_maxpool_tau_plain(s_feats, q_points, s_points, tau, tile, band_width, starts)
    check_no_grad("banded_maxpool_tau", s_feats, function="BandedMaxpoolTauFn")
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    if s_feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feature dtype {s_feats.dtype} not supported")
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32 or tau.dtype != torch.float32:
        raise ValueError("points and tau must be float32")
    if s_points.shape[:2] != (b, n) or tau.shape != (b, m):
        raise ValueError("shape mismatch between features, points and tau")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, s_feats.device, starts)
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points, tau=tau, starts=st)
    out = torch.empty(b, m, c, dtype=s_feats.dtype, device=s_feats.device)
    err = cuda_lib.lib().maxpool_tau_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), st.data_ptr(), tau.data_ptr(), out.data_ptr(),
        b, m, n, c, tile, band, cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "maxpool_tau")
    banded_maxpool_tau.launches += 1
    return out


banded_maxpool_tau.launches = 0


def _check_pool(s_feats, q_points, s_points, out):
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points, out=out)
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    if s_feats.dtype not in (torch.float32, torch.bfloat16) or out.dtype != s_feats.dtype:
        raise ValueError(f"features {s_feats.dtype} and output {out.dtype} must be one of float32, bfloat16")
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if s_points.shape[:2] != (b, n) or out.shape != (b, m, c):
        raise ValueError("shape mismatch between features, points and output")
    return b, m, n, c


def banded_maxpool_tie_count_fused(s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024,
                                   starts=None, tau=None):
    """Per (query, channel) count of member band rows tied at the forward
    max ``out`` (kernel #12), (B, M, C) fp32: on static bands or the
    forward's dynamic ``starts`` (B, num_tiles), members by d2 <=
    r_active² or, with ``tau`` (B, M), by d2 <= tau[m]; plain version
    ops/banded.py::banded_maxpool_tie_count."""
    if s_feats.device.type == "cpu":
        return banded_maxpool_tie_count_plain(s_feats, q_points, s_points, out, r_active, tile, band_width, starts,
                                              tau)
    check_no_grad("banded_maxpool_tie_count_fused", s_feats, out)
    b, m, n, c = _check_pool(s_feats, q_points, s_points, out)
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, s_feats.device, starts)
    _check_cuda(starts=st)
    if tau is not None:
        _check_tau(tau, b, m)
    cnt = torch.empty(b, m, c, dtype=torch.float32, device=s_feats.device)
    lib, common = cuda_lib.lib(), (q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
                                   int(s_feats.dtype == torch.bfloat16), st.data_ptr())
    if tau is None:
        err = lib.maxpool_count_launch(
            *common, out.data_ptr(), cnt.data_ptr(), b, m, n, c, tile, band,
            float(np.float32(r_active * r_active)), cuda_lib.stream_of(s_feats),
        )
    else:
        err = lib.maxpool_count_tau_launch(
            *common, tau.data_ptr(), out.data_ptr(), cnt.data_ptr(), b, m, n, c, tile, band,
            cuda_lib.stream_of(s_feats),
        )
    cuda_lib.check(err, "maxpool_count")
    banded_maxpool_tie_count_fused.launches += 1
    return cnt


banded_maxpool_tie_count_fused.launches = 0


def _check_tau(tau, b, m):
    if tau.dtype != torch.float32 or tau.shape != (b, m):
        raise ValueError(f"tau must be float32 of shape {(b, m)}")
    _check_cuda(tau=tau)


def _route_static(launcher, g_scaled, s_feats, q_points, s_points, out, tile, band_width, r2=None, tau=None):
    """Launch a maxpool routing pass on static bands (kernel #13 with
    ``r2``, #15 with ``tau``) through the library's ``launcher``, its
    windows planned for support tiles of the largest power of two <=
    :data:`ROUTE_TS` that divides N; returns (B, N, C) fp32."""
    gs = g_scaled.float().contiguous()
    b, m, n, c = _check_pool(s_feats, q_points, s_points, out)
    _check_cuda(g_scaled=gs)
    if gs.shape != (b, m, c):
        raise ValueError(f"cotangent shape {tuple(gs.shape)} != {(b, m, c)}")
    tile, num_tiles, band, _ = _band_geometry(m, n, tile, band_width)
    st = static_starts(m, n, tile, band, num_tiles, b, gs.device).contiguous()
    ts, qstart_blk, n_qtiles = _transpose_plan(m, n, tile, band, num_tiles, pick_tq(n, ROUTE_TS), gs.device)
    g_feats = torch.empty(b, n, c, dtype=torch.float32, device=gs.device)
    err = getattr(cuda_lib.lib(), launcher)(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), out.data_ptr(), gs.data_ptr(), st.data_ptr(),
        qstart_blk.data_ptr(), *(() if tau is None else (tau.data_ptr(),)), g_feats.data_ptr(), b, m, n, c, tile,
        num_tiles, band, ts, n_qtiles, *(() if r2 is None else (r2,)), cuda_lib.stream_of(gs),
    )
    cuda_lib.check(err, launcher)
    return g_feats


def banded_maxpool_backward_fused(g_scaled, s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024):
    """Maxpool feature gradient on static bands (kernel #13): routes
    ``g_scaled`` (B, M, C), the cotangent already divided by max(tie
    count, 1), to every in-reach band row tied at the max; (B, N, C) fp32.
    Plain version ops/banded.py::banded_maxpool_route."""
    if g_scaled.device.type == "cpu":
        return banded_maxpool_route_plain(g_scaled, s_feats, q_points, s_points, out, r_active, tile, band_width)
    check_no_grad("banded_maxpool_backward_fused", g_scaled, s_feats, out)
    g_feats = _route_static("maxpool_bwd_launch", g_scaled, s_feats, q_points, s_points, out, tile,
                            band_width, r2=float(np.float32(r_active * r_active)))
    banded_maxpool_backward_fused.launches += 1
    return g_feats


banded_maxpool_backward_fused.launches = 0


def route_dyn_with_stack(g_scaled, s_feats, q_points, s_points, out, starts, r_active, tile=128, band_width=256):
    """Kernel #14's two launches on CUDA tensors: the window stack
    (B, num_tiles, band, C) fp32, each window sliced into
    ``pick_tq(band, ROUTE_TS)`` rows a block, then its scatter; returns
    (g_feats (B, N, C) fp32, stack).  Counts nothing: the wrapper
    :func:`banded_maxpool_backward_dyn_fused` does."""
    gs = g_scaled.float().contiguous()
    b, m, n, c = _check_pool(s_feats, q_points, s_points, out)
    if gs.shape != (b, m, c):
        raise ValueError(f"cotangent shape {tuple(gs.shape)} != {(b, m, c)}")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, gs.device, starts)
    _check_cuda(g_scaled=gs, starts=st)
    stack = torch.empty(b, num_tiles, band, c, dtype=torch.float32, device=gs.device)
    err = cuda_lib.lib().maxpool_bwd_dyn_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(), int(s_feats.dtype == torch.bfloat16),
        out.data_ptr(), gs.data_ptr(), st.data_ptr(), stack.data_ptr(), b, m, n, c, tile, num_tiles, band,
        pick_tq(band, ROUTE_TS), float(np.float32(r_active * r_active)), cuda_lib.stream_of(gs),
    )
    cuda_lib.check(err, "maxpool_bwd_dyn")
    return band_scatter(stack, st, n), stack


def banded_maxpool_backward_dyn_fused(g_scaled, s_feats, q_points, s_points, out, starts, r_active, tile=128,
                                      band_width=256):
    """Maxpool feature gradient on dynamic windows (kernel #14): as
    :func:`banded_maxpool_backward_fused` over the forward's ``starts``
    (B, num_tiles) windows of width ``band_width``; each tile's window
    gradient goes to a stack, added up in tile order
    (:func:`route_dyn_with_stack`).  Plain version
    ops/banded.py::banded_maxpool_route with ``starts``."""
    if g_scaled.device.type == "cpu":
        return banded_maxpool_route_dyn_plain(g_scaled, s_feats, q_points, s_points, out, starts, r_active, tile,
                                              band_width)
    check_no_grad("banded_maxpool_backward_dyn_fused", g_scaled, s_feats, out)
    g_feats, _ = route_dyn_with_stack(g_scaled, s_feats, q_points, s_points, out, starts, r_active, tile, band_width)
    banded_maxpool_backward_dyn_fused.launches += 1
    return g_feats


banded_maxpool_backward_dyn_fused.launches = 0


def banded_maxpool_backward_tau_fused(g_scaled, s_feats, q_points, s_points, out, tau, tile=128, band_width=1024):
    """Maxpool feature gradient under k-NN semantics (kernel #15): as
    :func:`banded_maxpool_backward_fused` with the members d2 <= tau[m],
    tau (B, M) fp32, and no radius mask; plain version
    ops/banded.py::banded_maxpool_route with ``tau``."""
    if g_scaled.device.type == "cpu":
        return banded_maxpool_route_tau_plain(g_scaled, s_feats, q_points, s_points, out, tau, tile, band_width)
    check_no_grad("banded_maxpool_backward_tau_fused", g_scaled, s_feats, out)
    _check_tau(tau, *q_points.shape[:2])
    g_feats = _route_static("maxpool_bwd_tau_launch", g_scaled, s_feats, q_points, s_points, out, tile,
                            band_width, tau=tau)
    banded_maxpool_backward_tau_fused.launches += 1
    return g_feats


banded_maxpool_backward_tau_fused.launches = 0


class BandedMaxpoolFn(torch.autograd.Function):
    """Differentiable banded maxpool, the counterpart of the JAX package's
    ``custom_vjp`` (maxpool_kernel.py:229-233, 469-546): the forward
    kernel, then in the backward the tie count, the cotangent divided by
    max(count, 1), and the routing kernel: #13 on static bands, #14 on the
    forward's dynamic ``starts``."""

    @staticmethod
    def forward(ctx, s_feats, q_points, s_points, r_active, tile, band_width, starts=None):
        out = banded_maxpool_fused(s_feats, q_points, s_points, r_active, tile, band_width, starts)
        ctx.save_for_backward(s_feats, q_points, s_points, out, starts)
        ctx.args = (r_active, tile, band_width)
        return out

    @staticmethod
    def backward(ctx, g):
        s_feats, q_points, s_points, out, starts = ctx.saved_tensors
        r_active, tile, band_width = ctx.args
        cnt = banded_maxpool_tie_count_fused(s_feats, q_points, s_points, out, r_active, tile, band_width, starts)
        g_scaled = g.float() / torch.clamp(cnt, min=1.0)
        if starts is None:
            g_feats = banded_maxpool_backward_fused(g_scaled, s_feats, q_points, s_points, out, r_active, tile,
                                                    band_width)
        else:
            g_feats = banded_maxpool_backward_dyn_fused(g_scaled, s_feats, q_points, s_points, out, starts, r_active,
                                                        tile, band_width)
        return g_feats.to(s_feats.dtype), None, None, None, None, None, None


def banded_maxpool_apply(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
    """The model's banded maxpool: through :class:`BandedMaxpoolFn` when
    differentiated, else the forward kernel."""
    if torch.is_grad_enabled() and s_feats.requires_grad:
        return BandedMaxpoolFn.apply(s_feats, q_points, s_points, r_active, tile, band_width, starts)
    return banded_maxpool_fused(s_feats, q_points, s_points, r_active, tile, band_width, starts)


class BandedMaxpoolTauFn(torch.autograd.Function):
    """Differentiable k-NN maxpool on static bands, the counterpart of the
    JAX package's ``_tau_fwd``/``_tau_bwd`` (maxpool_kernel.py:679-795):
    kernel #8 forward; in the backward the tie count in tau mode (#12), the
    cotangent divided by max(count, 1), and kernel #15.  tau gets no
    gradient."""

    @staticmethod
    def forward(ctx, s_feats, q_points, s_points, tau, tile, band_width):
        out = banded_maxpool_tau(s_feats, q_points, s_points, tau, tile, band_width)
        ctx.save_for_backward(s_feats, q_points, s_points, tau, out)
        ctx.args = (tile, band_width)
        return out

    @staticmethod
    def backward(ctx, g):
        s_feats, q_points, s_points, tau, out = ctx.saved_tensors
        tile, band_width = ctx.args
        cnt = banded_maxpool_tie_count_fused(s_feats, q_points, s_points, out, 0.0, tile, band_width, tau=tau)
        g_scaled = g.float() / torch.clamp(cnt, min=1.0)
        g_feats = banded_maxpool_backward_tau_fused(g_scaled, s_feats, q_points, s_points, out, tau, tile, band_width)
        return g_feats.to(s_feats.dtype), None, None, None, None, None


def banded_maxpool_tau_apply(s_feats, q_points, s_points, tau, tile=128, band_width=1024, starts=None):
    """The model's k-NN maxpool: through :class:`BandedMaxpoolTauFn` when
    differentiated (k-NN window ``starts`` then raise, as JAX's
    ``_tau_fwd`` does), else kernel #8."""
    if torch.is_grad_enabled() and s_feats.requires_grad:
        if starts is not None:
            raise NotImplementedError(
                "kNN window starts are forward-only (the .t7 reproduction path never differentiates); "
                "train without kpconv_knn_window_plan"
            )
        return BandedMaxpoolTauFn.apply(s_feats, q_points, s_points, tau, tile, band_width)
    return banded_maxpool_tau(s_feats, q_points, s_points, tau, tile, band_width, starts)
