"""Banded radius-neighborhood ops: plain PyTorch versions and band geometry.

Counterpart of cofii2p_tpu/ops/banded.py.  Every pyramid level is Morton
sorted, so the support points within kernel reach of a contiguous tile of
queries sit inside a contiguous index band of the support level; each
query tile reads one band and computes membership and influence from
coordinates, with no neighbor index maps.

Everything here is batched over a leading frame axis: q_points (B, M, 3),
s_points (B, N, 3), s_feats (B, N, C).  These are the plain versions the
CPU tests compare against the JAX package and that ``chip_smoke.py``
compares the CUDA kernels against; the kernels themselves live in
ops/kpconv_kernel.py and ops/maxpool_kernel.py.

Exactness rules kept from the JAX package:
 - membership is ``d2 <= r2`` with d2 from :func:`_membership_d2` — centred
   on the tile's first query, per-dimension products added in d order, no
   fused multiply-add (eager PyTorch runs one op at a time, the CUDA
   kernels use the round-to-nearest intrinsics);
 - argmax / argmin take the first extremum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# elements of the largest intermediate one chunk of tiles may hold; bounds
# the plain versions' memory at KITTI scale
_CHUNK_ELEMS = 1 << 26


def _load_kernel_points(radius: float, kernel_size: int) -> np.ndarray:
    # imported here: the models package imports this module, so a
    # module-level import would make ops and models import each other
    from benchmark.reference.models.kernel_points import load_kernel_points

    return np.asarray(load_kernel_points(radius, kernel_size, 3))


def kernel_reach(radius: float, sigma: float, kernel_size: int = 15) -> float:
    """Max distance at which any kernel point has nonzero influence."""
    kp = _load_kernel_points(radius, kernel_size)
    return float(np.linalg.norm(kp, axis=-1).max() + sigma)


def _band_geometry(num_q: int, num_s: int, tile: int, band_width: int):
    """Static banding plan (tile, num_tiles, band, dense), as
    cofii2p_tpu/ops/banded.py::_band_geometry."""
    tile = min(tile, num_q)
    while num_q % tile:
        tile //= 2
    num_tiles = num_q // tile
    span = -(-tile * num_s // num_q)
    band = min(span + 2 * band_width, num_s)
    return tile, num_tiles, band, (num_tiles == 1 and band == num_s)


def _dyn_tile(num_q: int, tile: int):
    """Tile size and count under dynamic ``starts`` (the ``min(tile, m)``
    halving rule of cofii2p_tpu/ops/kpconv_kernel.py:982-985)."""
    tile = min(tile, num_q)
    while num_q % tile:
        tile //= 2
    return tile, num_q // tile


def _band_start(t: int, tile: int, num_q: int, num_s: int, band: int) -> int:
    """Start of tile t's support band (centred, edge-clipped)."""
    center = ((2 * t * tile + tile) * num_s) // (2 * num_q)
    return min(max(center - band // 2, 0), num_s - band)


def _band_starts_np(num_q: int, num_s: int, tile: int, band: int, num_tiles: int) -> np.ndarray:
    """Static band starts of every tile (cofii2p_tpu/ops/kpconv_kernel.py:132-144)."""
    return np.asarray(
        [_band_start(t, tile, num_q, num_s, band) for t in range(num_tiles)],
        dtype=np.int64,
    )


def band_plan(num_q: int, num_s: int, tile: int, band_width: int, starts=None):
    """(tile, num_tiles, band) of a banded op: the static plan, or under
    dynamic ``starts`` the tile rule above with ``band_width`` as the full
    window width."""
    if starts is None:
        tile, num_tiles, band, _ = _band_geometry(num_q, num_s, tile, band_width)
    else:
        tile, num_tiles = _dyn_tile(num_q, tile)
        band = min(band_width, num_s)
    return tile, num_tiles, band


@functools.lru_cache(maxsize=None)
def _static_starts_on(num_q, num_s, tile, band, num_tiles, device) -> torch.Tensor:
    # kept on the device: a copy from host memory on every call would block
    # the host until the card has drained its queue
    return torch.as_tensor(_band_starts_np(num_q, num_s, tile, band, num_tiles), dtype=torch.int32, device=device)


def static_starts(num_q, num_s, tile, band, num_tiles, batch, device) -> torch.Tensor:
    """(B, num_tiles) int32 static starts on ``device`` (a broadcast view of
    one cached row; callers must not write to it)."""
    return _static_starts_on(num_q, num_s, tile, band, num_tiles, torch.device(device))[None].expand(batch, num_tiles)


def _slice_bands_dyn(x: torch.Tensor, starts: torch.Tensor, band: int) -> torch.Tensor:
    """(B, N, D) and (B, nt) starts -> (B, nt, band, D) contiguous windows."""
    idx = starts.long()[..., None] + torch.arange(band, device=x.device)  # (B, nt, band)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def _membership_d2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances with the kernels' exact arithmetic.

    q (..., T, 3), p (..., S, 3) -> (..., T, S) fp32.  Both operands are
    centred on the tile's first query, then the per-dimension squares are
    added in d order (cofii2p_tpu/ops/banded.py:254-277).
    """
    ref = q[..., 0:1, :]
    qc = q - ref
    pc = p - ref
    d2 = None
    for d in range(3):
        diff = qc[..., :, None, d] - pc[..., None, :, d]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def _influence(offsets: torch.Tensor, kp: torch.Tensor, sigma: float) -> torch.Tensor:
    """Linear-correlation influence of each kernel point at each offset.

    offsets (..., 3) -> influence (..., K) fp32, by the matmul identity
    (cofii2p_tpu/ops/banded.py:295-308) taken in float64: in fp32 the
    identity cancels near a kernel point and the square root magnifies the
    rounding there, while the CUDA kernels take the difference to the
    kernel point directly; in float64 the plain version is an accurate
    reference for them.
    """
    o, k = offsets.double(), kp.double()
    sqk = torch.sum(o * o, dim=-1)[..., None] - 2.0 * torch.einsum("...d,kd->...k", o, k) + torch.sum(k * k, dim=-1)
    return torch.clamp(1.0 - torch.sqrt(torch.clamp(sqk, min=0.0)) / sigma, min=0.0).float()


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype`` and compute on in fp32: a product of two values
    rounded to bf16 is exact in fp32, so an fp32 matmul of rounded operands
    is the bf16 matmul with fp32 accumulation (JAX's
    ``preferred_element_type=float32``)."""
    return x.to(dtype).float()


def _tile_chunks(num_tiles: int, elems_per_tile: int):
    step = max(1, _CHUNK_ELEMS // max(elems_per_tile, 1))
    for t0 in range(0, num_tiles, step):
        yield t0, min(num_tiles, t0 + step)


def _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts):
    """Query tiles (B, nt, tile, 3) and their bands (B, nt, band, 3/C)."""
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    if starts is None:
        starts = static_starts(m, n, tile, band, num_tiles, b, q_points.device)
    qt = q_points.reshape(b, num_tiles, tile, 3)
    pb = _slice_bands_dyn(s_points, starts, band)
    fb = _slice_bands_dyn(s_feats, starts, band) if s_feats is not None else None
    return qt, pb, fb


def tau_reach2(radius: float, sigma: float, kernel_size: int = 15) -> float:
    """Squared reach mask of the k-NN (tau) aggregation with explicit
    per-layer kernel points: the canonical reach padded 10%, since a
    rotation keeps kernel-point norms and the reference's jitter is small
    (cofii2p_tpu/ops/banded.py:363-368)."""
    return (1.1 * kernel_reach(radius, sigma, kernel_size)) ** 2


def banded_kpconv_aggregate(
    s_feats, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32, starts=None, tau=None, kp=None,
):
    """Influence-weighted banded neighbor aggregation (plain version).

    weighted[m, k, c] = sum_j infl_k(q_m, s_j) * s_feats[j, c] over band rows
    j within kernel reach; count[m] = max(#in-reach band rows, 1).
    ``starts`` (B, nt): dynamic window starts; ``band_width`` is then the
    full window width.  (cofii2p_tpu/ops/banded.py:314-423)

    ``tau`` (B, M): the k-NN semantics of a reference checkpoint.  Rows
    with d2 <= tau[m] are the neighbourhood; they are aggregated where they
    also lie within the reach mask, and the count is the reference's
    active-row rule, max(#{d2 <= tau[m] and sum_c s_feats[j, c] > 0}, 1)
    (banded.py:381-385).  ``kp`` (K, 3): the layer's own kernel points; the
    reach mask is then :func:`tau_reach2`.

    Returns weighted (B, M, K, C) fp32 and count (B, M) int32.
    """
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    dev = q_points.device
    if kp is None:
        kp = torch.as_tensor(_load_kernel_points(radius, kernel_size), dtype=torch.float32, device=dev)
        r2 = kernel_reach(radius, sigma, kernel_size) ** 2
    else:
        kp = kp.to(device=dev, dtype=torch.float32)
        r2 = tau_reach2(radius, sigma, kernel_size)
    k_num = kp.shape[0]
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts)
    if tau is not None:
        tt = tau.reshape(b, num_tiles, tile)
        active = _slice_bands_dyn((s_feats.float().sum(-1) > 0.0)[..., None], _starts_of(
            m, n, tile, num_tiles, band, b, dev, starts), band)[..., 0]  # (B, nt, band)
    weighted = torch.empty(b, num_tiles, tile, k_num, c, dtype=torch.float32, device=dev)
    count = torch.empty(b, num_tiles, tile, dtype=torch.int32, device=dev)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * max(k_num, c)):
        q, p, f = qt[:, t0:t1], pb[:, t0:t1], fb[:, t0:t1]
        offs = p[:, :, None, :, :] - q[:, :, :, None, :]  # (B, t, T, band, 3)
        infl = _influence(offs, kp, sigma)  # (B, t, T, band, K)
        d2 = _membership_d2(q, p)  # (B, t, T, band)
        if tau is None:
            within = d2 <= r2
            cnt = within.sum(-1)
        else:
            within_tau = d2 <= tt[:, t0:t1, :, None]
            within = within_tau & (d2 <= r2)
            cnt = (within_tau & active[:, t0:t1, None, :]).sum(-1)
        infl = torch.where(within[..., None], infl, 0.0)
        count[:, t0:t1] = torch.clamp(cnt, min=1).to(torch.int32)
        weighted[:, t0:t1] = torch.einsum(
            "xytbk,xybc->xytkc", _round(infl, dtype), _round(f, dtype)
        )
    return weighted.reshape(b, m, k_num, c), count.reshape(b, m)


def banded_maxpool(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None, tau=None):
    """Max over in-reach band features (plain version); empty neighborhoods
    give 0.  Returns (B, M, C) in the dtype of ``s_feats``.  With ``tau``
    (B, M) the neighbourhood is {d2 <= tau[m]}, the reference's k-NN
    maxpool, with no radius mask; ``r_active`` is then unused.
    (cofii2p_tpu/ops/banded.py:429-499)"""
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    r2 = r_active * r_active
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts)
    tt = None if tau is None else tau.reshape(b, num_tiles, tile, 1)
    out = torch.empty(b, num_tiles, tile, c, dtype=s_feats.dtype, device=s_feats.device)
    neg = torch.tensor(float("-inf"), dtype=s_feats.dtype, device=s_feats.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * c):
        q, p, f = qt[:, t0:t1], pb[:, t0:t1], fb[:, t0:t1]
        within = _membership_d2(q, p) <= (r2 if tt is None else tt[:, t0:t1])  # (B, t, T, band)
        pooled = torch.where(within[..., None], f[:, :, None], neg).amax(dim=3)
        out[:, t0:t1] = torch.where(within.any(-1, keepdim=True), pooled, 0.0)
    return out.reshape(b, m, c)


def banded_knn_tau(q_points, s_points, k=128, tile=128, band_width=1024, starts=None):
    """Per query, the k-NN threshold over its band (plain version of
    cofii2p_tpu/ops/banded.py:771-854): with kk = min(k, band), kth and nxt
    the kk-th and (kk+1)-th smallest band d2 (:func:`_membership_d2`),

        tau = max(0.5 * (kth + nxt), kth * (1 + 1e-5) + 1e-12),

    and nxt = kth * (1 + 2e-6) + 2e-12 where the band has no (kk+1)-th row.
    The order statistics are exact data values (``torch.topk``), so tau is
    bit-equal to the JAX package's and to kernel #5's.  ``starts``
    (B, nt): each tile's window, of width ``band_width``.  Returns (B, M)
    fp32.
    """
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    kk = min(k, band)
    qt, pb, _ = _tiles(q_points, s_points, None, tile, num_tiles, band, starts)
    out = torch.empty(b, num_tiles, tile, dtype=torch.float32, device=q_points.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band):
        d2 = _membership_d2(qt[:, t0:t1], pb[:, t0:t1])
        top = torch.topk(d2, min(kk + 1, band), dim=-1, largest=False, sorted=True).values
        kth = top[..., kk - 1]
        nxt = top[..., kk] if kk < band else kth * (1.0 + 2e-6) + 2e-12
        out[:, t0:t1] = torch.maximum(0.5 * (kth + nxt), kth * (1.0 + 1e-5) + 1e-12)
    return out.reshape(b, m)


def banded_pair_count(q_points, s_points, r_active, tile=128, band_width=1024, starts=None, tau=None):
    """(B, M) int64 number of in-reach band rows of each query: the
    unclamped in-reach count, i.e. the pairs a banded op must visit.  With
    ``tau`` (B, M) a row must also have d2 <= tau[m]; ``r_active`` None
    drops the reach test."""
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    qt, pb, _ = _tiles(q_points, s_points, None, tile, num_tiles, band, starts)
    r2 = float("inf") if r_active is None else float(np.float32(r_active * r_active))
    tt = None if tau is None else tau.reshape(b, num_tiles, tile, 1)
    out = torch.empty(b, num_tiles, tile, dtype=torch.int64, device=q_points.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band):
        d2 = _membership_d2(qt[:, t0:t1], pb[:, t0:t1])
        within = d2 <= r2 if tt is None else (d2 <= r2) & (d2 <= tt[:, t0:t1])
        out[:, t0:t1] = within.sum(-1)
    return out.reshape(b, m)


def _starts_of(m, n, tile, num_tiles, band, b, device, starts):
    if starts is None:
        return static_starts(m, n, tile, band, num_tiles, b, device)
    return starts


def banded_nearest_index(q_points, s_points, tile=128, band_width=1024):
    """Index of each query's nearest support point within its static band;
    (B, M) int64 absolute indices.  (cofii2p_tpu/ops/banded.py:858-888)"""
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles, band, _ = _band_geometry(m, n, tile, band_width)
    starts = static_starts(m, n, tile, band, num_tiles, b, q_points.device)
    qt, pb, _ = _tiles(q_points, s_points, None, tile, num_tiles, band, starts)
    local = torch.argmin(_membership_d2(qt, pb), dim=-1)  # (B, nt, T)
    return (local + starts[..., None]).reshape(b, m)


def dynamic_band_starts(q_points, s_points, r_active, tile=128, width=256, center="best", stride=1):
    """Per-tile window starts measured from the frame's geometry
    (cofii2p_tpu/ops/banded.py:96-190).  ``center`` picks the estimator:

    - ``'best'``: the width-W window of support rows holding the most
      in-reach (query, row) pairs, estimated on every ``stride``-th row.  As
      in the JAX package, the "has in-reach support" flag is taken over the
      sampled rows only, so a sparse tile may fall back to the static start;
    - ``'centroid'``: the window centred on the pair-weighted mean in-reach
      row, truncated from fp32 ``sum(j * count_j) / max(sum(count_j), 1)``;
    - ``'span'``: the window centred on the first and last in-reach rows.

    The last two run over each tile's full (tile, N) distance block and
    take no ``stride`` > 1.  A tile with no in-reach row takes the static
    proportional start.  Returns (B, num_tiles) int32 starts clipped to
    [0, N - width].
    """
    r2 = np.float32(np.float32(r_active * r_active) * np.float32(1.0001))
    if center == "best":
        return _best_windows(q_points, s_points, lambda t0, t1: float(r2), tile, width, stride)
    if center not in ("centroid", "span"):
        raise ValueError(f"center {center!r} is not 'best', 'centroid' or 'span'")
    if stride > 1:
        raise NotImplementedError("stride>1 is implemented for center='best'")
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles = _dyn_tile(m, tile)
    width = min(width, n)
    qt = q_points.reshape(b, num_tiles, tile, 3)
    rows = torch.arange(n, device=q_points.device)
    out = torch.empty(b, num_tiles, dtype=torch.int64, device=q_points.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * n):
        wcnt = (_membership_d2(qt[:, t0:t1], s_points[:, None]) <= float(r2)).sum(dim=2)  # (B, t, N)
        within = wcnt > 0
        if center == "centroid":
            w = wcnt.float()
            mid = (rows.float() * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
            dyn = mid.to(torch.int64) - width // 2
        else:
            jmin = torch.argmax(within.to(torch.int8), dim=-1)
            jmax = n - 1 - torch.argmax(within.flip(-1).to(torch.int8), dim=-1)
            dyn = torch.div(jmin + jmax + 1 - width, 2, rounding_mode="floor")
        t = torch.arange(t0, t1, device=q_points.device)
        static = ((2 * t * tile + tile) * n) // (2 * m) - width // 2
        out[:, t0:t1] = torch.where(within.any(-1), dyn, static)
    return torch.clamp(out, 0, n - width).to(torch.int32)


def _best_windows(q_points, s_points, threshold, tile, width, stride):
    """Each query tile's width-W window of support rows holding the most
    (query, row) pairs with d2 <= ``threshold(t0, t1)`` (a scalar, or the
    (B, t, T, 1) thresholds of tiles t0..t1), counted on every
    ``stride``-th row; the static proportional start where no sampled row
    is a member.  Returns (B, num_tiles) int32 starts in [0, N - width]."""
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles = _dyn_tile(m, tile)
    width = min(width, n)
    s_sub = s_points[:, ::stride] if stride > 1 else s_points
    n_sub = s_sub.shape[1]
    w_sub = max(width // stride, 1)
    qt = q_points.reshape(b, num_tiles, tile, 3)
    out = torch.empty(b, num_tiles, dtype=torch.int64, device=q_points.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * n_sub):
        within = _membership_d2(qt[:, t0:t1], s_sub[:, None]) <= threshold(t0, t1)  # (B, t, T, n_sub)
        wcnt = within.sum(dim=2)  # (B, t, n_sub)
        has = wcnt.sum(-1) > 0
        cs = torch.nn.functional.pad(torch.cumsum(wcnt, dim=-1), (1, 0))
        win = cs[..., w_sub:] - cs[..., : n_sub - w_sub + 1]
        dyn = torch.argmax(win, dim=-1) * stride
        t = torch.arange(t0, t1, device=q_points.device)
        static = ((2 * t * tile + tile) * n) // (2 * m) - width // 2
        out[:, t0:t1] = torch.where(has, dyn, static)
    return torch.clamp(out, 0, n - width).to(torch.int32)
