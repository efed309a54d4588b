"""Banded KPConv: the CUDA kernels' wrappers, their plain versions and the
autograd Function that differentiates through them.

Counterpart of cofii2p_tpu/ops/kpconv_kernel.py.  Seven kernels:
 - :func:`banded_kpconv_fused` (csrc/kpconv_fused.cu; replaces
   banded_kpconv_fused_pallas) aggregates the in-reach band rows of each
   query and contracts with the (K, Cin, Cout) weights in one pass; the
   (B, M, K, Cin) aggregate never reaches device memory;
 - :func:`banded_kpconv_aggregate_fused` (csrc/kpconv_aggregate.cu, the
   tensor-core kernel of csrc/kpconv_tau_mma.cuh under radius membership;
   replaces banded_kpconv_aggregate_pallas) writes that aggregate, the
   residual the weight gradient needs;
 - :func:`banded_kpconv_transpose_fused` (csrc/kpconv_transpose.cu, the
   tensor-core kernel of csrc/kpconv_transpose_mma.cuh under radius
   membership; replaces _transpose_agg) is the aggregate's feature
   gradient on static bands, :func:`banded_kpconv_transpose_dyn_fused`
   (the same kernel in its window mode, then csrc/band_scatter.cu;
   replaces _transpose_agg_dyn) on dynamic windows;
 - :func:`banded_kpconv_fused_tau` and :func:`banded_kpconv_aggregate_tau`
   (csrc/kpconv_tau.cu, the tensor-core kernel of csrc/kpconv_tau_mma.cuh;
   replace banded_kpconv_fused_tau_pallas and
   banded_kpconv_aggregate_tau_pallas) are the two under the k-NN semantics
   of a reference checkpoint: membership d2 <= tau[m], the layer's own
   kernel points, the active-row count;
   :func:`banded_kpconv_transpose_tau_fused` (csrc/kpconv_transpose.cu,
   the tensor-core kernel of csrc/kpconv_transpose_mma.cuh; replaces
   _transpose_agg_tau) is their feature gradient.

Every kernel here runs on the tensor cores in both precisions, fp32 by
3xTF32: :func:`banded_kpconv_fused` on csrc/kpconv_mma.cuh, the aggregate
(#2) and the two tau kernels on csrc/kpconv_tau_mma.cuh, the three
transposed passes (#9, #10, #11) on csrc/kpconv_transpose_mma.cuh, each
kernel with its block plan (``MmaPlan``, ``TauPlan``, ``TransposePlan``)
from csrc/kpconv_mma_plan.cuh.  The two fused kernels read W in the
fragment layout :func:`fused_weights` ships: :func:`mma_weights`' in bf16,
:func:`tf32_weights`' in fp32.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; there is no other fallback.  A wrapper returns
no autograd history, so on the card it refuses inputs that require grad
under grad mode: differentiation goes through :class:`BandedKPConvFn` and
:class:`BandedKPConvTauFn` (:func:`banded_kpconv_apply` and
:func:`banded_kpconv_tau_apply` pick the path), as the JAX package goes
through its ``custom_vjp``s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import (
    _band_geometry,
    _band_starts_np,
    _kernel_points,
    _round,
    band_plan,
    banded_kpconv_aggregate,
    banded_kpconv_aggregate_transpose,
    bwd_geometry,
    kernel_reach,
    scatter_band_stacks,
    static_starts,
    tau_reach2,
)

MAX_CHANNELS = 512  # Cin and Cout the kernels take
# support rows per block of the tensor-core transposed kernel, #9, #10 and
# #11 (csrc/kpconv_mma_plan.cuh TransposePlan::TS): the host plans each
# support tile's window of query tiles (static bands), or slices each
# window (#10), for blocks of this size
TRANSPOSE_TS = 64

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


def mma_pad(c: int) -> int:
    """Cin or Cout as the tensor-core kernel pads it: a power of two >= 32
    (csrc/kpconv_mma_plan.cuh::mma_pad)."""
    return max(32, 1 << _pad_shift(c))


def _mma_perm(ci: int) -> list:
    """Cin order of :func:`mma_weights`: within each 32 channels, lane
    group t's 16 bytes hold its B fragments of two k-steps, channels 2t,
    2t+1, 8+2t, 9+2t of the first 16 and the same of the next 16."""
    within = [o + 2 * t + e for t in range(4) for o in (0, 8, 16, 24) for e in (0, 1)]
    return [g + c for g in range(0, ci, 32) for c in within]


def mma_weights(weights, ci: int, co: int):
    """W (K, Cin, Cout) as the tensor-core kernel reads it: rounded to
    bf16 (the values the compute dtype gives), zero-padded to (CI, CO),
    transposed to (K, CO, CI) and Cin permuted by :func:`_mma_perm`."""
    k_num, cin, cout = weights.shape
    w = torch.zeros(k_num, ci, co, dtype=torch.bfloat16, device=weights.device)
    w[:, :cin, :cout] = weights.to(torch.bfloat16)
    return w.index_select(1, _perm_on("mma", ci, weights.device)).transpose(1, 2).contiguous()


def _tf32_perm(ci: int) -> list:
    """Cin order of :func:`tf32_weights`: within each 8 channels, lane
    group t's 8 bytes hold its B fragment (b0, b1) of the tf32 k-step,
    channels t and t + 4."""
    return [g + c for g in range(0, ci, 8) for c in (0, 4, 1, 5, 2, 6, 3, 7)]


def tf32_weights(weights, ci: int, co: int):
    """W (K, Cin, Cout) as the fused kernels read it in fp32 (3xTF32): fp32,
    zero-padded to (CI, CO), transposed to (K, CO, CI) and Cin permuted by
    :func:`_tf32_perm`; the kernel splits each value into tf32 hi + lo."""
    k_num, cin, cout = weights.shape
    w = torch.zeros(k_num, ci, co, dtype=torch.float32, device=weights.device)
    w[:, :cin, :cout] = weights.float()
    return w.index_select(1, _perm_on("tf32", ci, weights.device)).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _perm_on(layout: str, ci: int, device) -> torch.Tensor:
    """A layout's Cin permutation, kept on ``device`` as the kernel points
    are: a copy from host memory on every call would block the host until
    the card has drained its queue (and cannot be captured in a graph)."""
    return torch.as_tensor((_mma_perm if layout == "mma" else _tf32_perm)(ci), device=device)


def fused_weights(weights, dtype):
    """W (K, Cin, Cout) as kernels #1 and #7 (and #16's conv half) read it
    in the compute dtype: :func:`mma_weights`' layout in bf16,
    :func:`tf32_weights`' in fp32, padded to the built widths; the block
    takes its queries from its plan (csrc/kpconv_mma_plan.cuh ``MmaPlan``)."""
    _, cin, cout = weights.shape
    layout = mma_weights if dtype == torch.bfloat16 else tf32_weights
    return layout(weights, mma_pad(cin), mma_pad(cout))


def pick_tq(tile: int, limit: int) -> int:
    """Largest power of two <= limit that divides the band tile."""
    tq = 1
    while tq * 2 <= limit and tile % (tq * 2) == 0:
        tq *= 2
    return tq


def _check_cuda(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_no_grad(what: str, *tensors, function: str | None = None) -> None:
    """A kernel's output carries no autograd history: refuse inputs that
    would need one instead of silently cutting the gradient.  ``function``
    names the autograd Function that differentiates through the kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        how = (f"differentiate through {function}" if function else
               "it runs inside the autograd Functions' backward (ops/kpconv_kernel.py, ops/maxpool_kernel.py)")
        raise RuntimeError(f"{what}: the CUDA kernel returns no autograd history; {how}")


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
    check_no_grad("banded_kpconv_fused", s_feats, weights, function="BandedKPConvFn")
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
    w = fused_weights(weights, dtype)
    kp = _kernel_points(float(radius), int(kernel_size), s_feats.device)
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points, weights=w, starts=st)
    out = torch.empty(b, m, cout, dtype=torch.float32, device=s_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=s_feats.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    err = cuda_lib.lib().kpconv_fused_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), w.data_ptr(), kp.data_ptr(),
        st.data_ptr(), out.data_ptr(), count.data_ptr(),
        b, m, n, cin, cout, k_num, tile, num_tiles, band,
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
    (B, M) int32 = max(#in-reach band rows, 1), over static bands or
    ``starts`` windows; fp32 compute by 3xTF32 on the tensor cores, bf16 on
    bf16 products.  Plain version ops/banded.py::banded_kpconv_aggregate."""
    if s_feats.device.type == "cpu":
        return banded_kpconv_aggregate_plain(
            s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    check_no_grad("banded_kpconv_aggregate_fused", s_feats, function="BandedKPConvFn")
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
    weighted = torch.empty(b, m, k_num, cin, dtype=torch.float32, device=s_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=s_feats.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    # the block takes its TauPlan's queries (csrc/kpconv_mma_plan.cuh)
    err = cuda_lib.lib().kpconv_aggregate_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), kp.data_ptr(), st.data_ptr(),
        weighted.data_ptr(), count.data_ptr(), b, m, n, cin, k_num, tile,
        num_tiles, band, int(dtype == torch.bfloat16), r2, float(sigma),
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


def _check_transpose(g_weighted, q_points, s_points, kernel_size):
    """Checks shared by the transposed wrappers; returns g in fp32 and the
    shapes (B, M, K, C, N)."""
    g = g_weighted.float().contiguous()
    _check_cuda(g_weighted=g, q_points=q_points, s_points=s_points)
    b, m, k_num, c = g.shape
    if q_points.dtype != torch.float32 or s_points.dtype != torch.float32:
        raise ValueError("points must be float32")
    if k_num != kernel_size or q_points.shape[:2] != (b, m) or s_points.shape[0] != b:
        raise ValueError("shape mismatch between the cotangent and the points")
    if c > MAX_CHANNELS:
        raise ValueError(f"C <= {MAX_CHANNELS} supported, got {c}")
    return g, (b, m, k_num, c, s_points.shape[1])


def _transpose_static(launcher, g_weighted, q_points, s_points, kp, r2, sigma, kernel_size, tile, band_width,
                      dtype, *tau):
    """Launch a transposed pass on static bands (kernel #9, or #11 with
    ``tau``) through the library's ``launcher``, each block taking the
    largest power of two <= :data:`TRANSPOSE_TS` support rows that divides
    N; returns (B, N, C) fp32."""
    g, (b, m, k_num, c, n) = _check_transpose(g_weighted, q_points, s_points, kernel_size)
    tile, num_tiles, band, _ = _band_geometry(m, n, tile, band_width)
    st = static_starts(m, n, tile, band, num_tiles, b, g.device).contiguous()
    ts, qstart_blk, n_qtiles = _transpose_plan(m, n, tile, band, num_tiles, pick_tq(n, TRANSPOSE_TS), g.device)
    out = torch.empty(b, n, c, dtype=torch.float32, device=g.device)
    err = getattr(cuda_lib.lib(), launcher)(
        q_points.data_ptr(), s_points.data_ptr(), g.data_ptr(), kp.data_ptr(),
        st.data_ptr(), qstart_blk.data_ptr(), *(t.data_ptr() for t in tau), out.data_ptr(), b, m, n, c,
        k_num, tile, num_tiles, band, ts, n_qtiles,
        int(dtype == torch.bfloat16), r2, float(sigma), cuda_lib.stream_of(g),
    )
    cuda_lib.check(err, launcher)
    return out


def banded_kpconv_transpose_fused(
    g_weighted, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32,
):
    """Transposed banded aggregation on static bands (kernel #9): the
    feature gradient (B, N, C) fp32 of the aggregate from its cotangent
    g_weighted (B, M, K, C); on the tensor cores, blocks of
    :data:`TRANSPOSE_TS` support rows, fp32 by 3xTF32.  Plain version
    ops/banded.py::banded_kpconv_aggregate_transpose."""
    if g_weighted.device.type == "cpu":
        return banded_kpconv_transpose_plain(
            g_weighted, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
        )
    check_no_grad("banded_kpconv_transpose_fused", g_weighted)
    out = _transpose_static(
        "kpconv_transpose_launch", g_weighted, q_points, s_points,
        _kernel_points(float(radius), int(kernel_size), g_weighted.device),
        float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2)), sigma, kernel_size, tile, band_width, dtype,
    )
    banded_kpconv_transpose_fused.launches += 1
    return out


banded_kpconv_transpose_fused.launches = 0


def banded_kpconv_transpose_dyn_plain(
    g_weighted, q_points, s_points, starts, radius, sigma, kernel_size=15, tile=128,
    band_width=256, dtype=torch.float32,
):
    """Plain version of :func:`banded_kpconv_transpose_dyn_fused`."""
    return banded_kpconv_aggregate_transpose(
        g_weighted, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )


def transpose_dyn_with_stack(
    g_weighted, q_points, s_points, starts, radius, sigma, kernel_size=15, tile=128,
    band_width=256, dtype=torch.float32,
):
    """Kernel #10's two launches on CUDA tensors: the window stack
    (B, num_tiles, band, C) fp32, each block taking the largest power of two
    <= :data:`TRANSPOSE_TS` rows that divides the window width, then its
    scatter; returns (g_feats (B, N, C) fp32, stack).  Counts nothing: the
    wrapper :func:`banded_kpconv_transpose_dyn_fused` does."""
    g, (b, m, k_num, c, n) = _check_transpose(g_weighted, q_points, s_points, kernel_size)
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, g.device, starts)
    _check_cuda(starts=st)
    kp = _kernel_points(float(radius), int(kernel_size), g.device)
    stack = torch.empty(b, num_tiles, band, c, dtype=torch.float32, device=g.device)
    r2 = float(np.float32(kernel_reach(radius, sigma, kernel_size) ** 2))
    err = cuda_lib.lib().kpconv_transpose_dyn_launch(
        q_points.data_ptr(), s_points.data_ptr(), g.data_ptr(), kp.data_ptr(), st.data_ptr(),
        stack.data_ptr(), b, m, n, c, k_num, tile, num_tiles, band,
        pick_tq(band, TRANSPOSE_TS), int(dtype == torch.bfloat16), r2,
        float(sigma), cuda_lib.stream_of(g),
    )
    cuda_lib.check(err, "kpconv_transpose_dyn")
    return band_scatter(stack, st, n), stack


def band_scatter(stack, starts, n):
    """csrc/band_scatter.cu: the window stack (B, nt, band, C) fp32 added
    back to (B, N, C) fp32 in tile order; plain version
    ops/banded.py::scatter_band_stacks."""
    b, nt, band, c = stack.shape
    out = torch.empty(b, n, c, dtype=torch.float32, device=stack.device)
    err = cuda_lib.lib().band_scatter_launch(
        stack.data_ptr(), starts.data_ptr(), out.data_ptr(), b, n, c, nt, band, cuda_lib.stream_of(stack),
    )
    cuda_lib.check(err, "band_scatter")
    return out


band_scatter_plain = scatter_band_stacks


def banded_kpconv_transpose_dyn_fused(
    g_weighted, q_points, s_points, starts, radius, sigma, kernel_size=15, tile=128,
    band_width=256, dtype=torch.float32,
):
    """Transposed banded aggregation on dynamic windows (kernel #10): the
    feature gradient (B, N, C) fp32 of the aggregate taken over ``starts``
    (B, num_tiles) windows of width ``band_width``, on the tensor cores
    (fp32 by 3xTF32).  Each tile's window gradient goes to a stack, and the
    overlapping windows are added in tile order
    (:func:`transpose_dyn_with_stack`); plain version
    ops/banded.py::banded_kpconv_aggregate_transpose with ``starts``."""
    if g_weighted.device.type == "cpu":
        return banded_kpconv_transpose_dyn_plain(
            g_weighted, q_points, s_points, starts, radius, sigma, kernel_size, tile, band_width, dtype,
        )
    check_no_grad("banded_kpconv_transpose_dyn_fused", g_weighted)
    out, _ = transpose_dyn_with_stack(
        g_weighted, q_points, s_points, starts, radius, sigma, kernel_size, tile, band_width, dtype,
    )
    banded_kpconv_transpose_dyn_fused.launches += 1
    return out


banded_kpconv_transpose_dyn_fused.launches = 0


class BandedKPConvFn(torch.autograd.Function):
    """Differentiable banded KPConv, the counterpart of the JAX package's
    ``_fused_fwd``/``_fused_bwd`` (and ``_fwd``/``_bwd`` with the
    contraction outside): the forward runs the aggregate kernel and the
    contraction as a matmul in the compute dtype, keeping ``weighted`` for
    the weight gradient; the backward contracts the cotangent with W, runs
    the transposed kernel for the feature gradient where the features need
    one (kernel #9 on static bands, #10 on dynamic ``starts``), and
    contracts ``weighted`` with the cotangent for dW.  Returns (out
    (B, M, Cout) fp32 unnormalised, count (B, M) int32, no gradient).
    """

    @staticmethod
    def forward(ctx, s_feats, weights, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
                starts=None):
        weighted, count = banded_kpconv_aggregate_fused(
            s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
        out = torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype))
        ctx.save_for_backward(weights, weighted, q_points, s_points, starts)
        ctx.args = (radius, sigma, kernel_size, tile, band_width, dtype)
        ctx.feats_dtype = s_feats.dtype
        ctx.mark_non_differentiable(count)
        return out, count

    @staticmethod
    def backward(ctx, g_out, _g_count):
        weights, weighted, q_points, s_points, starts = ctx.saved_tensors
        radius, sigma, kernel_size, tile, band_width, dtype = ctx.args
        g_out = _round(g_out, dtype)
        g_feats = g_w = None
        if ctx.needs_input_grad[0]:
            g_weighted = torch.einsum("bmd,kcd->bmkc", g_out, _round(weights, dtype))
            if starts is None:
                g_feats = banded_kpconv_transpose_fused(
                    g_weighted, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype,
                )
            else:
                g_feats = banded_kpconv_transpose_dyn_fused(
                    g_weighted, q_points, s_points, starts, radius, sigma, kernel_size, tile, band_width, dtype,
                )
            g_feats = g_feats.to(ctx.feats_dtype)
        if ctx.needs_input_grad[1]:
            g_w = torch.einsum("bmkc,bmd->kcd", _round(weighted, dtype), g_out).to(weights.dtype)
        return g_feats, g_w, None, None, None, None, None, None, None, None, None


def banded_kpconv_apply(
    s_feats, q_points, s_points, weights, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None, fused=True,
):
    """The banded KPConv of the model: (out (B, M, Cout) fp32 unnormalised,
    count (B, M) int32).

    Differentiated (grad mode on and the features or W requiring grad) it
    runs :class:`BandedKPConvFn`, on static bands or dynamic ``starts``;
    otherwise the fused kernel where ``fused`` (see
    :func:`fused_contraction_fits`), else the aggregate kernel and a
    matmul, as cofii2p_tpu/models/kpconv.py:355-382 chooses.
    """
    if torch.is_grad_enabled() and (s_feats.requires_grad or weights.requires_grad):
        return BandedKPConvFn.apply(
            s_feats, weights, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    if fused:
        return banded_kpconv_fused(
            s_feats, q_points, s_points, weights, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    weighted, count = banded_kpconv_aggregate_fused(
        s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
    return torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype)), count


# ---------------------------------------------------------------------------
# k-NN (tau) semantics: kernels #6, #7 and #11
# ---------------------------------------------------------------------------


def banded_kpconv_aggregate_tau_plain(
    s_feats, q_points, s_points, tau, kp, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Plain version of :func:`banded_kpconv_aggregate_tau`."""
    return banded_kpconv_aggregate(
        s_feats, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, starts, tau=tau, kp=kp,
    )


def banded_kpconv_fused_tau_plain(
    s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Plain version of :func:`banded_kpconv_fused_tau`: the tau
    aggregation, then the contraction in ``dtype`` with fp32 accumulation."""
    weighted, count = banded_kpconv_aggregate_tau_plain(
        s_feats, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
    return torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype)), count


def _tau_launch_args(s_feats, q_points, s_points, tau, kp, kernel_size, tile, band_width, dtype, starts):
    """Checks shared by the two tau wrappers; returns the plan, the starts,
    the kernel points and the active-row scratch."""
    b, m = q_points.shape[:2]
    n, cin = s_feats.shape[1:]
    _check_feats(s_feats, q_points, s_points, cin)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} not supported")
    if tau.dtype != torch.float32 or tau.shape != (b, m):
        raise ValueError(f"tau must be float32 of shape {(b, m)}")
    if kp.shape != (kernel_size, 3):
        raise ValueError(f"kernel points of shape {tuple(kp.shape)} != {(kernel_size, 3)}")
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    st = _starts_arg(m, n, tile, band, num_tiles, b, s_feats.device, starts)
    kp32 = kp.float().contiguous()
    _check_cuda(s_feats=s_feats, q_points=q_points, s_points=s_points, tau=tau, kernel_points=kp32, starts=st)
    active = torch.empty(b, n, dtype=torch.int32, device=s_feats.device)
    return b, m, n, cin, tile, num_tiles, band, st, kp32, active


def banded_kpconv_fused_tau(
    s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Banded KPConv under k-NN semantics with the contraction fused in
    (kernel #7): band rows with d2 <= tau[m] (tau (B, M) from
    ops/tau_kernel.py) aggregated within the padded reach of the layer's
    kernel points ``kp`` (K, 3).  Returns (out (B, M, Cout) fp32
    unnormalised, count (B, M) int32, the active-row count)."""
    if s_feats.device.type == "cpu":
        return banded_kpconv_fused_tau_plain(
            s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size,
            tile, band_width, dtype, starts,
        )
    check_no_grad("banded_kpconv_fused_tau", s_feats, weights, function="BandedKPConvTauFn")
    b, m, n, cin, tile, num_tiles, band, st, kp32, active = _tau_launch_args(
        s_feats, q_points, s_points, tau, kp, kernel_size, tile, band_width, dtype, starts,
    )
    k_num, w_cin, cout = weights.shape
    if w_cin != cin or k_num != kernel_size:
        raise ValueError("shape mismatch between features and weights")
    if cout > MAX_CHANNELS:
        raise ValueError(f"Cout <= {MAX_CHANNELS} supported, got {cout}")
    w = fused_weights(weights, dtype)
    _check_cuda(weights=w)
    out = torch.empty(b, m, cout, dtype=torch.float32, device=s_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=s_feats.device)
    err = cuda_lib.lib().kpconv_fused_tau_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), w.data_ptr(), kp32.data_ptr(), st.data_ptr(),
        tau.data_ptr(), active.data_ptr(), out.data_ptr(), count.data_ptr(),
        b, m, n, cin, cout, k_num, tile, num_tiles, band, int(dtype == torch.bfloat16),
        float(np.float32(tau_reach2(radius, sigma, kernel_size))), float(sigma), cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "kpconv_fused_tau")
    banded_kpconv_fused_tau.launches += 1
    return out, count


banded_kpconv_fused_tau.launches = 0


def banded_kpconv_aggregate_tau(
    s_feats, q_points, s_points, tau, kp, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None,
):
    """Banded aggregation under k-NN semantics (kernel #6): weighted
    (B, M, K, Cin) fp32 and the active-row count (B, M) int32; arguments
    as :func:`banded_kpconv_fused_tau`."""
    if s_feats.device.type == "cpu":
        return banded_kpconv_aggregate_tau_plain(
            s_feats, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    check_no_grad("banded_kpconv_aggregate_tau", s_feats, function="BandedKPConvTauFn")
    b, m, n, cin, tile, num_tiles, band, st, kp32, active = _tau_launch_args(
        s_feats, q_points, s_points, tau, kp, kernel_size, tile, band_width, dtype, starts,
    )
    k_num = kernel_size
    weighted = torch.empty(b, m, k_num, cin, dtype=torch.float32, device=s_feats.device)
    count = torch.empty(b, m, dtype=torch.int32, device=s_feats.device)
    err = cuda_lib.lib().kpconv_aggregate_tau_launch(
        q_points.data_ptr(), s_points.data_ptr(), s_feats.data_ptr(),
        int(s_feats.dtype == torch.bfloat16), kp32.data_ptr(), st.data_ptr(), tau.data_ptr(),
        active.data_ptr(), weighted.data_ptr(), count.data_ptr(), b, m, n, cin, k_num, tile,
        num_tiles, band, int(dtype == torch.bfloat16),
        float(np.float32(tau_reach2(radius, sigma, kernel_size))), float(sigma), cuda_lib.stream_of(s_feats),
    )
    cuda_lib.check(err, "kpconv_aggregate_tau")
    banded_kpconv_aggregate_tau.launches += 1
    return weighted, count


banded_kpconv_aggregate_tau.launches = 0


def banded_kpconv_transpose_tau_plain(
    g_weighted, q_points, s_points, tau, kp, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32,
):
    """Plain version of :func:`banded_kpconv_transpose_tau_fused`."""
    return banded_kpconv_aggregate_transpose(
        g_weighted, q_points, s_points, radius, sigma, kernel_size, tile, band_width, dtype, tau=tau, kp=kp,
    )


def banded_kpconv_transpose_tau_fused(
    g_weighted, q_points, s_points, tau, kp, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32,
):
    """Transposed banded aggregation under k-NN semantics (kernel #11): the
    feature gradient (B, N, C) fp32 of :func:`banded_kpconv_aggregate_tau`
    on static bands, membership (d2 <= tau_reach2) & (d2 <= tau[m]) and the
    layer's own kernel points ``kp`` (K, 3); on the tensor cores, blocks of
    :data:`TRANSPOSE_TS` support rows, fp32 by 3xTF32.  Plain version
    ops/banded.py::banded_kpconv_aggregate_transpose with ``tau`` and
    ``kp``."""
    if g_weighted.device.type == "cpu":
        return banded_kpconv_transpose_tau_plain(
            g_weighted, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype,
        )
    check_no_grad("banded_kpconv_transpose_tau_fused", g_weighted)
    b, m = q_points.shape[:2]
    if tau.dtype != torch.float32 or tau.shape != (b, m):
        raise ValueError(f"tau must be float32 of shape {(b, m)}")
    if kp.shape != (kernel_size, 3):
        raise ValueError(f"kernel points of shape {tuple(kp.shape)} != {(kernel_size, 3)}")
    kp32 = kp.float().contiguous()
    _check_cuda(tau=tau, kernel_points=kp32)
    out = _transpose_static(
        "kpconv_transpose_tau_launch", g_weighted, q_points, s_points, kp32,
        float(np.float32(tau_reach2(radius, sigma, kernel_size))), sigma, kernel_size, tile, band_width, dtype, tau,
    )
    banded_kpconv_transpose_tau_fused.launches += 1
    return out


banded_kpconv_transpose_tau_fused.launches = 0


class BandedKPConvTauFn(torch.autograd.Function):
    """Differentiable banded KPConv under k-NN semantics, the counterpart
    of the JAX package's ``_fused_tau_fwd``/``_fused_tau_bwd`` (and
    ``_tau_fwd``/``_tau_bwd``, kpconv_kernel.py:717-846, 1239-1278): the
    forward runs the aggregate tau kernel (#6) and the contraction in the
    compute dtype; the backward contracts the cotangent with W, runs kernel
    #11 for the feature gradient where the features need one, and contracts
    ``weighted`` with the cotangent for dW.  tau and the kernel points get
    no gradient: coordinates are data and ``kernel_points`` is a frozen
    buffer (JAX's stop_gradient, models/kpconv.py:170-172).  Static bands
    only: k-NN window starts are forward-only, as in the JAX package.
    Returns (out (B, M, Cout) fp32 unnormalised, count (B, M) int32, no
    gradient)."""

    @staticmethod
    def forward(ctx, s_feats, weights, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width,
                dtype):
        weighted, count = banded_kpconv_aggregate_tau(
            s_feats, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype,
        )
        out = torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype))
        ctx.save_for_backward(weights, weighted, q_points, s_points, tau, kp)
        ctx.args = (radius, sigma, kernel_size, tile, band_width, dtype)
        ctx.feats_dtype = s_feats.dtype
        ctx.mark_non_differentiable(count)
        return out, count

    @staticmethod
    def backward(ctx, g_out, _g_count):
        weights, weighted, q_points, s_points, tau, kp = ctx.saved_tensors
        radius, sigma, kernel_size, tile, band_width, dtype = ctx.args
        g_out = _round(g_out, dtype)
        g_feats = g_w = None
        if ctx.needs_input_grad[0]:
            g_weighted = torch.einsum("bmd,kcd->bmkc", g_out, _round(weights, dtype))
            g_feats = banded_kpconv_transpose_tau_fused(
                g_weighted, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype,
            ).to(ctx.feats_dtype)
        if ctx.needs_input_grad[1]:
            g_w = torch.einsum("bmkc,bmd->kcd", _round(weighted, dtype), g_out).to(weights.dtype)
        return g_feats, g_w, None, None, None, None, None, None, None, None, None, None


def banded_kpconv_tau_apply(
    s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size=15,
    tile=128, band_width=1024, dtype=torch.float32, starts=None, fused=True,
):
    """The model's KPConv under k-NN semantics.  Returns (out (B, M, Cout)
    fp32 unnormalised, count (B, M) int32).

    Differentiated (grad mode on and the features or W requiring grad) it
    runs :class:`BandedKPConvTauFn`, whose forward is the aggregate kernel,
    as JAX's ``_tau_fwd``/``_fused_tau_fwd`` run the unfused aggregate;
    with k-NN window ``starts`` it raises, as they do.  Otherwise the fused
    kernel where ``fused`` (:func:`fused_contraction_fits`), else the
    aggregate kernel and a matmul, as cofii2p_tpu/models/kpconv.py:231-299
    chooses."""
    if torch.is_grad_enabled() and (s_feats.requires_grad or weights.requires_grad):
        if starts is not None:
            raise NotImplementedError(
                "kNN window starts are forward-only (the .t7 reproduction path never differentiates); "
                "train without kpconv_knn_window_plan"
            )
        return BandedKPConvTauFn.apply(
            s_feats, weights, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype,
        )
    if fused:
        return banded_kpconv_fused_tau(
            s_feats, q_points, s_points, weights, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype, starts,
        )
    weighted, count = banded_kpconv_aggregate_tau(
        s_feats, q_points, s_points, tau, kp, radius, sigma, kernel_size, tile, band_width, dtype, starts,
    )
    return torch.einsum("bmkc,kcd->bmd", _round(weighted, dtype), _round(weights, dtype)), count
