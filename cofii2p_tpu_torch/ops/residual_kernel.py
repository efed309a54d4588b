"""The strided ResidualBlock's fused band pass: the CUDA kernel's wrapper,
its plain version and the path the model takes through it.

Counterpart of cofii2p_tpu/ops/residual_kernel.py.  A strided bottleneck
block runs two banded sweeps over the same geometry: its KPConv aggregates
``unary1(x)`` (Cmid channels) over each query's in-reach band rows and
contracts with W, and its shortcut maxpools the block input ``x`` (Cin
channels) over the same rows.  :func:`banded_residual_fused`
(csrc/residual_fused.cu; replaces banded_residual_fused_pallas) computes
the membership once and serves both from it.

The wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; there is no other fallback.  Differentiated,
:func:`banded_residual_apply` runs the unfused pair through
``BandedKPConvFn`` and ``BandedMaxpoolFn``, as the JAX package's
``custom_vjp`` forward runs the unfused Pallas pair, so training keeps the
pair's backward kernels and tie-splitting.
"""

from __future__ import annotations

import numpy as np
import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import band_plan, kernel_reach
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    MAX_CHANNELS,
    _check_cuda,
    _kernel_points,
    _starts_arg,
    banded_kpconv_apply,
    banded_kpconv_fused_plain,
    check_no_grad,
    fused_weights,
)
from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_apply, banded_maxpool_plain

_BCH = 128  # band rows per grid cell of the TPU kernel (residual_fits' budget)
MAX_POOL_CHANNELS = 1024  # Cin the kernel's shortcut takes (encoder5_1's)


def residual_fused_fits(kernel_size: int, cmid: int, dout: int, cin: int, band: int, tile: int = 128,
                        wbytes: int = 4, fbytes: int = 4) -> bool:
    """Whether a strided block takes the fused pass, by the JAX package's
    rule (a copy of cofii2p_tpu/ops/residual_kernel.py:268-290): the TPU
    kernel's weight block, fp32 accumulator, membership scratch and
    (tile, band chunk, Cin chunk) select temporary within 11 MB of VMEM.
    It is the reference's dispatch rule, kept so that the same blocks fuse
    on both sides, not a limit of the CUDA kernel.  ``wbytes`` is the
    compute dtype's size, ``fbytes`` the maxpooled features'."""
    cc = 128 if cin % 128 == 0 else cin
    bch = _BCH if band % _BCH == 0 else band
    need = (
        kernel_size * cmid * dout * wbytes
        + tile * kernel_size * cmid * 4
        + tile * bch * 4
        + tile * bch * cc * fbytes
        + bch * cmid * 4
    )
    return need <= 11 * 2**20


def banded_residual_fused_plain(
    mp_feats, agg_feats, weights, q_points, s_points, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Plain version: ops/kpconv_kernel.py::banded_kpconv_fused_plain on
    ``agg_feats`` and ops/banded.py::banded_maxpool on ``mp_feats``, both
    over d2 <= kernel_reach(radius, sigma)^2.  Returns (conv_out (B, M, Dout)
    fp32 unnormalised, count (B, M) int32, shortcut (B, M, Cin) in
    mp_feats' dtype)."""
    out, count = banded_kpconv_fused_plain(
        agg_feats, q_points, s_points, weights, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
    shortcut = banded_maxpool_plain(
        mp_feats, q_points, s_points, kernel_reach(radius, sigma, kernel_size), tile, band_width, starts,
    )
    return out, count, shortcut


def banded_residual_fused(
    mp_feats, agg_feats, weights, q_points, s_points, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """The fused band pass of a strided ResidualBlock (kernel #16).

    mp_feats (B, N, Cin) the block input the shortcut maxpools, agg_feats
    (B, N, Cmid) the ``unary1`` output the conv aggregates, both fp32 or
    bf16; weights (K, Cmid, Dout); q_points (B, M, 3), s_points (B, N, 3)
    fp32; ``starts`` (B, num_tiles) dynamic window starts (``band_width``
    is then the full window width).  Returns (conv_out (B, M, Dout) fp32
    unnormalised: divide by count and add the bias outside; count (B, M)
    int32 = max(#in-reach band rows, 1); shortcut (B, M, Cin) in mp_feats'
    dtype, 0 where no band row is in reach): #1's conv and #3's maxpool on
    the same inputs, from one membership pass.
    """
    if agg_feats.device.type == "cpu":
        return banded_residual_fused_plain(
            mp_feats, agg_feats, weights, q_points, s_points, radius, sigma, kernel_size,
            tile, band_width, dtype, starts,
        )
    check_no_grad("banded_residual_fused", mp_feats, agg_feats, weights,
                  function="BandedKPConvFn and BandedMaxpoolFn (banded_residual_apply)")
    b, m = q_points.shape[:2]
    n, cmid = agg_feats.shape[1:]
    cin = mp_feats.shape[-1]
    k_num, w_cin, dout = weights.shape
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} not supported")
    for name, f in (("agg_feats", agg_feats), ("mp_feats", mp_feats)):
        if f.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} dtype {f.dtype} not supported")
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if (w_cin != cmid or k_num != kernel_size or s_points.shape[:2] != (b, n)
            or mp_feats.shape[:2] != (b, n)):
        raise ValueError("shape mismatch between features, points and weights")
    if cmid > MAX_CHANNELS or dout > MAX_CHANNELS:
        raise ValueError(f"Cmid, Dout <= {MAX_CHANNELS} supported, got {cmid}, {dout}")
    if cin > MAX_POOL_CHANNELS:
        raise ValueError(f"Cin <= {MAX_POOL_CHANNELS} supported, got {cin}")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, agg_feats.device, starts)
    # #1's weights (ops/kpconv_kernel.py::banded_kpconv_fused); the kernel
    # takes #1's plan, so the conv half sums in #1's order
    w = fused_weights(weights, dtype)
    kp = _kernel_points(float(radius), int(kernel_size), agg_feats.device)
    _check_cuda(mp_feats=mp_feats, agg_feats=agg_feats, q_points=q_points, s_points=s_points, weights=w, starts=st)
    out = torch.empty(b, m, dout, dtype=torch.float32, device=agg_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=agg_feats.device)
    shortcut = torch.empty(b, m, cin, dtype=mp_feats.dtype, device=agg_feats.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    err = cuda_lib.lib().residual_fused_launch(
        q_points.data_ptr(), s_points.data_ptr(), agg_feats.data_ptr(), int(agg_feats.dtype == torch.bfloat16),
        mp_feats.data_ptr(), int(mp_feats.dtype == torch.bfloat16), w.data_ptr(), kp.data_ptr(), st.data_ptr(),
        out.data_ptr(), count.data_ptr(), shortcut.data_ptr(),
        b, m, n, cmid, dout, cin, k_num, tile, num_tiles, band,
        int(dtype == torch.bfloat16), r2, float(sigma), cuda_lib.stream_of(agg_feats),
    )
    cuda_lib.check(err, "residual_fused")
    banded_residual_fused.launches += 1
    return out, count, shortcut


banded_residual_fused.launches = 0


def banded_residual_apply(
    mp_feats, agg_feats, weights, q_points, s_points, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """The strided block's conv and shortcut: (conv_out (B, M, Dout) fp32
    unnormalised, count (B, M) int32, shortcut (B, M, Cin)).

    Differentiated (grad mode on and a feature tensor or W requiring grad)
    it runs the unfused pair, :func:`banded_kpconv_apply` and
    :func:`banded_maxpool_apply` through their autograd Functions, as the
    JAX package's ``_res_fwd`` runs the unfused Pallas pair under
    ``jax.vjp``; otherwise the fused kernel.  The caller checks
    :func:`residual_fused_fits` (cofii2p_tpu/models/kpconv.py:323-337).
    """
    if torch.is_grad_enabled() and (mp_feats.requires_grad or agg_feats.requires_grad or weights.requires_grad):
        out, count = banded_kpconv_apply(
            agg_feats, q_points, s_points, weights, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
        shortcut = banded_maxpool_apply(
            mp_feats, q_points, s_points, kernel_reach(radius, sigma, kernel_size), tile, band_width, starts,
        )
        return out, count, shortcut
    return banded_residual_fused(
        mp_feats, agg_feats, weights, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
