"""Banded KPConv: the CUDA kernels' wrappers, their plain versions and the
autograd Function that differentiates through them.

Counterpart of cofii2p_tpu/ops/kpconv_kernel.py.  Three kernels:
 - :func:`banded_kpconv_fused` (csrc/kpconv_fused.cu; replaces
   banded_kpconv_fused_pallas) aggregates the in-reach band rows of each
   query and contracts with the (K, Cin, Cout) weights in one pass; the
   (B, M, K, Cin) aggregate never reaches device memory;
 - :func:`banded_kpconv_aggregate_fused` (the same source, contraction
   off; replaces banded_kpconv_aggregate_pallas) writes that aggregate,
   the residual the weight gradient needs;
 - :func:`banded_kpconv_transpose_fused` (csrc/kpconv_transpose.cu;
   replaces _transpose_agg) is the aggregate's feature gradient on static
   bands.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; there is no other fallback.  A wrapper returns
no autograd history, so on the card it refuses inputs that require grad
under grad mode: differentiation goes through :class:`BandedKPConvFn`
(:func:`banded_kpconv_apply` picks the path), as the JAX package goes
through its ``custom_vjp``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import (
    _band_geometry,
    _band_starts_np,
    _load_kernel_points,
    _round,
    band_plan,
    banded_kpconv_aggregate,
    banded_kpconv_aggregate_transpose,
    bwd_geometry,
    kernel_reach,
    static_starts,
)

MAX_CHANNELS = 512  # Cin and Cout the kernels take
_ACC_ELEMS = 8192  # per-block accumulator bound (csrc/kpconv_fused.cu, csrc/kpconv_transpose.cu)
_MAX_TQ = 32  # queries (support rows in the transposed kernel) per block

banded_kpconv_aggregate_plain = banded_kpconv_aggregate
banded_kpconv_transpose_plain = banded_kpconv_aggregate_transpose


def banded_kpconv_fused_plain(
    s_feats, q_points, s_points, weights, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Plain version: banded aggregation, then the contraction with the
    aggregate and W rounded to ``dtype`` and fp32 accumulation.  Returns
    (out (B, M, Cout) fp32 unnormalised, count (B, M) int32)."""
    weighted, count = banded_kpconv_aggregate(
        s_feats, q_points, s_points, radius, sigma, kernel_size, tile,
        band_width, dtype, starts,
    )
    out = torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype))
    return out, count


def _pad_shift(x: int) -> int:
    return max(int(x) - 1, 0).bit_length()


def pick_tq(tile: int, limit: int) -> int:
    """Largest power of two <= limit that divides the band tile."""
    tq = 1
    while tq * 2 <= limit and tile % (tq * 2) == 0:
        tq *= 2
    return tq


@functools.lru_cache(maxsize=None)
def _kernel_points(radius, kernel_size, device):
    kp = _load_kernel_points(radius, kernel_size).astype(np.float32)
    return torch.as_tensor(kp, device=device).contiguous()


def _check_cuda(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_no_grad(what: str, *tensors) -> None:
    """A kernel's output carries no autograd history: refuse inputs that
    would need one instead of silently cutting the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel returns no autograd history; differentiate through "
            "its autograd Function (ops/kpconv_kernel.py, ops/maxpool_kernel.py)"
        )


def fused_contraction_fits(kernel_size: int, cin: int, cout: int, tile: int = 128, wbytes: int = 4) -> bool:
    """Whether a conv takes the fused kernel in the forward, by the JAX
    package's rule (a copy of cofii2p_tpu/ops/kpconv_kernel.py:924-937):
    the W block plus the (tile, K*Cin) fp32 scratch within the TPU's VMEM
    budget, 6 MB with fp32 weights and 12 MB with bf16.  Convs over it run
    the aggregate kernel and a matmul, as there.  ``wbytes`` is the
    compute dtype's size."""
    return kernel_size * cin * cout * wbytes + tile * kernel_size * cin * 4 <= (12 if wbytes == 2 else 6) * 2**20


def _starts_arg(m, n, tile, band, num_tiles, b, device, starts):
    if starts is None:
        return static_starts(m, n, tile, band, num_tiles, b, device).contiguous()
    if starts.shape != (b, num_tiles):
        raise ValueError(f"starts shape {tuple(starts.shape)} != {(b, num_tiles)}")
    return starts.to(torch.int32).contiguous()


def banded_kpconv_fused(
    s_feats, q_points, s_points, weights, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Banded KPConv with the weight contraction fused in.

    s_feats (B, N, Cin) fp32 or bf16, q_points (B, M, 3), s_points
    (B, N, 3) fp32, weights (K, Cin, Cout); ``starts`` (B, num_tiles)
    dynamic window starts (``band_width`` is then the full window width).
    Returns (out (B, M, Cout) fp32 unnormalised, count (B, M) int32).
    """
    if s_feats.device.type == "cpu":
        return banded_kpconv_fused_plain(
            s_feats, q_points, s_points, weights, radius, sigma, kernel_size,
            tile, band_width, dtype, starts,
        )
    check_no_grad("banded_kpconv_fused", s_feats, weights)
    b, m = q_points.shape[:2]
    n, cin = s_feats.shape[1:]
    k_num, w_cin, cout = weights.shape
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} not supported")
    if s_feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feature dtype {s_feats.dtype} not supported")
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if w_cin != cin or k_num != kernel_size or s_points.shape[:2] != (b, n):
        raise ValueError("shape mismatch between features, points and weights")
    if cin > MAX_CHANNELS or cout > MAX_CHANNELS:
        raise ValueError(f"Cin, Cout <= {MAX_CHANNELS} supported, got {cin}, {cout}")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, s_feats.device, starts)
    w = weights.to(dtype).float().contiguous()
    kp = _kernel_points(float(radius), int(kernel_size), s_feats.device)
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points, weights=w, starts=st)
    cs, os_ = _pad_shift(cin), _pad_shift(cout)
    # a block's active rows are the union of its queries' neighborhoods, so
    # more queries per block means more zero-influence products: <= 32
    tq = pick_tq(tile, min(_MAX_TQ, _ACC_ELEMS >> cs, _ACC_ELEMS >> os_))
    out = torch.empty(b, m, cout, dtype=torch.float32, device=s_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=s_feats.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    err = cuda_lib.lib().kpconv_fused_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), w.data_ptr(), kp.data_ptr(),
        st.data_ptr(), out.data_ptr(), count.data_ptr(),
        b, m, n, cin, cout, k_num, tile, num_tiles, band, tq,
        int(dtype == torch.bfloat16), r2, float(sigma),
        cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "kpconv_fused")
    banded_kpconv_fused.launches += 1
    return out, count


banded_kpconv_fused.launches = 0


def _check_feats(s_feats, q_points, s_points, cin):
    if s_feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feature dtype {s_feats.dtype} not supported")
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if s_points.shape[:2] != s_feats.shape[:2]:
        raise ValueError("shape mismatch between features and points")
    if cin > MAX_CHANNELS:
        raise ValueError(f"C <= {MAX_CHANNELS} supported, got {cin}")


def banded_kpconv_aggregate_fused(
    s_feats, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32, starts=None,
):
    """Banded aggregation (kernel #2): weighted (B, M, K, Cin) fp32, the
    in-reach influence-weighted feature sums per kernel point, and count
    (B, M) int32 = max(#in-reach band rows, 1); plain version
    ops/banded.py::banded_kpconv_aggregate."""
    if s_feats.device.type == "cpu":
        return banded_kpconv_aggregate_plain(
            s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    check_no_grad("banded_kpconv_aggregate_fused", s_feats)
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points)
    b, m = q_points.shape[:2]
    n, cin = s_feats.shape[1:]
    _check_feats(s_feats, q_points, s_points, cin)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} not supported")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, s_feats.device, starts)
    kp = _kernel_points(float(radius), int(kernel_size), s_feats.device)
    k_num = kp.shape[0]
    tq = pick_tq(tile, min(_MAX_TQ, _ACC_ELEMS >> _pad_shift(cin)))
    weighted = torch.empty(b, m, k_num, cin, dtype=torch.float32, device=s_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=s_feats.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    err = cuda_lib.lib().kpconv_aggregate_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), kp.data_ptr(), st.data_ptr(),
        weighted.data_ptr(), count.data_ptr(), b, m, n, cin, k_num, tile,
        num_tiles, band, tq, int(dtype == torch.bfloat16), r2, float(sigma),
        cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "kpconv_aggregate")
    banded_kpconv_aggregate_fused.launches += 1
    return weighted, count


banded_kpconv_aggregate_fused.launches = 0


@functools.lru_cache(maxsize=None)
def _transpose_plan(m, n, tile, band, num_tiles, stile, device):
    """Static plan of a transposed pass on ``device``: the support-tile
    size, each support tile's first query tile and the window length in
    tiles (ops/banded.py::bwd_geometry)."""
    starts = _band_starts_np(m, n, tile, band, num_tiles)
    stile, _, q_win, qstart_blk = bwd_geometry(m, n, tile, band, starts, stile)
    return stile, torch.as_tensor(qstart_blk, device=device), q_win // tile


def banded_kpconv_transpose_fused(
    g_weighted, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32,
):
    """Transposed banded aggregation on static bands (kernel #9): the
    feature gradient (B, N, C) fp32 of the aggregate from its cotangent
    g_weighted (B, M, K, C); plain version
    ops/banded.py::banded_kpconv_aggregate_transpose."""
    if g_weighted.device.type == "cpu":
        return banded_kpconv_transpose_plain(
            g_weighted, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
        )
    check_no_grad("banded_kpconv_transpose_fused", g_weighted)
    g = g_weighted.float().contiguous()
    _check_cuda(g_weighted=g, q_points=q_points, s_points=s_points)
    b, m, k_num, c = g.shape
    n = s_points.shape[1]
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if k_num != kernel_size or q_points.shape[:2] != (b, m) or s_points.shape[0] != b:
        raise ValueError("shape mismatch between the cotangent and the points")
    if c > MAX_CHANNELS:
        raise ValueError(f"C <= {MAX_CHANNELS} supported, got {c}")
    tile, num_tiles, band, _ = _band_geometry(m, n, tile, band_width)
    st = static_starts(m, n, tile, band, num_tiles, b, g.device).contiguous()
    ts, qstart_blk, n_qtiles = _transpose_plan(
        m, n, tile, band, num_tiles, pick_tq(n, min(_MAX_TQ, _ACC_ELEMS >> _pad_shift(c))), g.device
    )
    kp = _kernel_points(float(radius), int(kernel_size), g.device)
    out = torch.empty(b, n, c, dtype=torch.float32, device=g.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    err = cuda_lib.lib().kpconv_transpose_launch(
        q_points.data_ptr(), s_points.data_ptr(), g.data_ptr(), kp.data_ptr(),
        st.data_ptr(), qstart_blk.data_ptr(), out.data_ptr(), b, m, n, c,
        k_num, tile, num_tiles, band, ts, n_qtiles,
        int(dtype == torch.bfloat16), r2, float(sigma), cuda_lib.stream_of(g),
    )
    cuda_lib.check(err, "kpconv_transpose")
    banded_kpconv_transpose_fused.launches += 1
    return out


banded_kpconv_transpose_fused.launches = 0


class BandedKPConvFn(torch.autograd.Function):
    """Differentiable banded KPConv on static bands, the counterpart of the
    JAX package's ``_fused_fwd``/``_fused_bwd`` (and ``_fwd``/``_bwd`` with
    the contraction outside): the forward runs the aggregate kernel and the
    contraction as a matmul in the compute dtype, keeping ``weighted`` for
    the weight gradient; the backward contracts the cotangent with W, runs
    the transposed kernel for the feature gradient where the features need
    one, and contracts ``weighted`` with the cotangent for dW.  Returns
    (out (B, M, Cout) fp32 unnormalised, count (B, M) int32, no gradient).
    """

    @staticmethod
    def forward(ctx, s_feats, weights, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype):
        weighted, count = banded_kpconv_aggregate_fused(
            s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
        )
        out = torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype))
        ctx.save_for_backward(weights, weighted, q_points, s_points)
        ctx.args = (radius, sigma, kernel_size, tile, band_width, dtype)
        ctx.feats_dtype = s_feats.dtype
        ctx.mark_non_differentiable(count)
        return out, count

    @staticmethod
    def backward(ctx, g_out, _g_count):
        weights, weighted, q_points, s_points = ctx.saved_tensors
        radius, sigma, kernel_size, tile, band_width, dtype = ctx.args
        g_out = _round(g_out, dtype)
        g_feats = g_w = None
        if ctx.needs_input_grad[0]:
            g_weighted = torch.einsum("bmd,kcd->bmkc", g_out, _round(weights, dtype))
            g_feats = banded_kpconv_transpose_fused(
                g_weighted, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
            ).to(ctx.feats_dtype)
        if ctx.needs_input_grad[1]:
            g_w = torch.einsum("bmkc,bmd->kcd", _round(weighted, dtype), g_out).to(weights.dtype)
        return g_feats, g_w, None, None, None, None, None, None, None, None


def banded_kpconv_apply(
    s_feats, q_points, s_points, weights, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None, fused=True,
):
    """The banded KPConv of the model: (out (B, M, Cout) fp32 unnormalised,
    count (B, M) int32).

    Differentiated (grad mode on and the features or W requiring grad) it
    runs :class:`BandedKPConvFn`; otherwise the fused kernel where
    ``fused`` (see :func:`fused_contraction_fits`), else the aggregate
    kernel and a matmul, as cofii2p_tpu/models/kpconv.py:355-382 chooses.
    """
    if torch.is_grad_enabled() and (s_feats.requires_grad or weights.requires_grad):
        if starts is not None:
            raise NotImplementedError(
                "the KPConv backward under dynamic windows (_transpose_agg_dyn, kernel #10) is not ported yet"
            )
        return BandedKPConvFn.apply(
            s_feats, weights, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
        )
    if fused:
        return banded_kpconv_fused(
            s_feats, q_points, s_points, weights, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    weighted, count = banded_kpconv_aggregate_fused(
        s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
    return torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype)), count
