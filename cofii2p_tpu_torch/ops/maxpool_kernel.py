"""Banded maxpool: the CUDA kernels' wrappers, their plain versions and the
autograd Function that differentiates through them.

Counterpart of cofii2p_tpu/ops/maxpool_kernel.py.  Three kernels:
 - :func:`banded_maxpool_fused` (csrc/maxpool.cu; replaces
   banded_maxpool_pallas) keeps per-query membership as a bitmask in
   shared memory and reads a feature row only where it is in reach;
 - :func:`banded_maxpool_tie_count_fused` (the same source in count mode;
   replaces _match_count) counts the in-reach rows tied at the max;
 - :func:`banded_maxpool_backward_fused` (csrc/maxpool_bwd.cu; replaces
   _bwd) routes the tie-divided cotangent to those rows, transposed over
   support tiles, on static bands.

Each wrapper takes its plain version (ops/banded.py) for a CPU tensor and
launches its kernel for a CUDA tensor; there is no other fallback.
Differentiation goes through :class:`BandedMaxpoolFn`
(:func:`banded_maxpool_apply` picks the path).
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
    check_no_grad,
    pick_tq,
)

_MAX_TS = 32  # support rows per block of the backward (csrc/maxpool_bwd.cu)

banded_maxpool_plain = banded_maxpool
banded_maxpool_tie_count_plain = banded_maxpool_tie_count
banded_maxpool_route_plain = banded_maxpool_route


def banded_maxpool_fused(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
    """Max over in-reach band features; 0 where none is in reach.

    s_feats (B, N, C) fp32 or bf16, q_points (B, M, 3), s_points (B, N, 3)
    fp32, optional dynamic ``starts`` (B, num_tiles).  Returns (B, M, C) in
    the dtype of ``s_feats``.
    """
    if s_feats.device.type == "cpu":
        return banded_maxpool_plain(s_feats, q_points, s_points, r_active, tile, band_width, starts)
    check_no_grad("banded_maxpool_fused", s_feats)
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
        b, m, n, c, tile, band, pick_tq(tile, 16),
        float(np.float32(r_active * r_active)), cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "maxpool")
    banded_maxpool_fused.launches += 1
    return out


banded_maxpool_fused.launches = 0


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


def banded_maxpool_tie_count_fused(s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024):
    """Per (query, channel) count of in-reach band rows tied at the forward
    max ``out`` (kernel #12), (B, M, C) fp32, static bands; plain version
    ops/banded.py::banded_maxpool_tie_count."""
    if s_feats.device.type == "cpu":
        return banded_maxpool_tie_count_plain(s_feats, q_points, s_points, out, r_active, tile, band_width)
    check_no_grad("banded_maxpool_tie_count_fused", s_feats, out)
    b, m, n, c = _check_pool(s_feats, q_points, s_points, out)
    tile, num_tiles, band, _ = _band_geometry(m, n, tile, band_width)
    st = static_starts(m, n, tile, band, num_tiles, b, s_feats.device).contiguous()
    cnt = torch.empty(b, m, c, dtype=torch.float32, device=s_feats.device)
    err = cuda_lib.lib().maxpool_count_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), st.data_ptr(), out.data_ptr(), cnt.data_ptr(),
        b, m, n, c, tile, band, pick_tq(tile, 16),
        float(np.float32(r_active * r_active)), cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "maxpool_count")
    banded_maxpool_tie_count_fused.launches += 1
    return cnt


banded_maxpool_tie_count_fused.launches = 0


def banded_maxpool_backward_fused(g_scaled, s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024):
    """Maxpool feature gradient on static bands (kernel #13): routes
    ``g_scaled`` (B, M, C), the cotangent already divided by max(tie
    count, 1), to every in-reach band row tied at the max; (B, N, C) fp32.
    Plain version ops/banded.py::banded_maxpool_route."""
    if g_scaled.device.type == "cpu":
        return banded_maxpool_route_plain(g_scaled, s_feats, q_points, s_points, out, r_active, tile, band_width)
    check_no_grad("banded_maxpool_backward_fused", g_scaled, s_feats, out)
    gs = g_scaled.float().contiguous()
    b, m, n, c = _check_pool(s_feats, q_points, s_points, out)
    _check_cuda(g_scaled=gs)
    if gs.shape != (b, m, c):
        raise ValueError(f"cotangent shape {tuple(gs.shape)} != {(b, m, c)}")
    tile, num_tiles, band, _ = _band_geometry(m, n, tile, band_width)
    st = static_starts(m, n, tile, band, num_tiles, b, gs.device).contiguous()
    ts, qstart_blk, n_qtiles = _transpose_plan(m, n, tile, band, num_tiles, pick_tq(n, _MAX_TS), gs.device)
    g_feats = torch.empty(b, n, c, dtype=torch.float32, device=gs.device)
    err = cuda_lib.lib().maxpool_bwd_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), out.data_ptr(), gs.data_ptr(), st.data_ptr(),
        qstart_blk.data_ptr(), g_feats.data_ptr(), b, m, n, c, tile, num_tiles, band, ts,
        n_qtiles, float(np.float32(r_active * r_active)), cuda_lib.stream_of(gs),
    )
    cuda_lib.check(err, "maxpool_bwd")
    banded_maxpool_backward_fused.launches += 1
    return g_feats


banded_maxpool_backward_fused.launches = 0


class BandedMaxpoolFn(torch.autograd.Function):
    """Differentiable banded maxpool on static bands, the counterpart of the
    JAX package's ``custom_vjp`` (maxpool_kernel.py:229-233, 469-546): the
    forward kernel, then in the backward the tie count, the cotangent
    divided by max(count, 1), and the routing kernel."""

    @staticmethod
    def forward(ctx, s_feats, q_points, s_points, r_active, tile, band_width):
        out = banded_maxpool_fused(s_feats, q_points, s_points, r_active, tile, band_width)
        ctx.save_for_backward(s_feats, q_points, s_points, out)
        ctx.args = (r_active, tile, band_width)
        return out

    @staticmethod
    def backward(ctx, g):
        s_feats, q_points, s_points, out = ctx.saved_tensors
        r_active, tile, band_width = ctx.args
        cnt = banded_maxpool_tie_count_fused(s_feats, q_points, s_points, out, r_active, tile, band_width)
        g_scaled = g.float() / torch.clamp(cnt, min=1.0)
        g_feats = banded_maxpool_backward_fused(g_scaled, s_feats, q_points, s_points, out, r_active, tile, band_width)
        return g_feats.to(s_feats.dtype), None, None, None, None, None


def banded_maxpool_apply(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
    """The model's banded maxpool: through :class:`BandedMaxpoolFn` when
    differentiated, else the forward kernel."""
    if torch.is_grad_enabled() and s_feats.requires_grad:
        if starts is not None:
            raise NotImplementedError(
                "the maxpool backward under dynamic windows (_bwd_dyn, kernel #14) is not ported yet"
            )
        return BandedMaxpoolFn.apply(s_feats, q_points, s_points, r_active, tile, band_width)
    return banded_maxpool_fused(s_feats, q_points, s_points, r_active, tile, band_width, starts)
