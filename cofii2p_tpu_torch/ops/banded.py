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

from cofii2p_tpu_torch.models.kernel_points import load_kernel_points

# elements of the largest intermediate one chunk of tiles may hold; bounds
# the plain versions' memory at KITTI scale
_CHUNK_ELEMS = 1 << 26


def _load_kernel_points(radius: float, kernel_size: int) -> np.ndarray:
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


def banded_kpconv_aggregate(
    s_feats, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32, starts=None,
):
    """Influence-weighted banded neighbor aggregation (plain version).

    weighted[m, k, c] = sum_j infl_k(q_m, s_j) * s_feats[j, c] over band rows
    j within kernel reach; count[m] = max(#in-reach band rows, 1).
    ``starts`` (B, nt): dynamic window starts; ``band_width`` is then the
    full window width.  (cofii2p_tpu/ops/banded.py:314-423)

    Returns weighted (B, M, K, C) fp32 and count (B, M) int32.
    """
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    dev = q_points.device
    kp = torch.as_tensor(_load_kernel_points(radius, kernel_size), dtype=torch.float32, device=dev)
    k_num = kp.shape[0]
    r2 = kernel_reach(radius, sigma, kernel_size) ** 2
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts)
    weighted = torch.empty(b, num_tiles, tile, k_num, c, dtype=torch.float32, device=dev)
    count = torch.empty(b, num_tiles, tile, dtype=torch.int32, device=dev)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * max(k_num, c)):
        q, p, f = qt[:, t0:t1], pb[:, t0:t1], fb[:, t0:t1]
        offs = p[:, :, None, :, :] - q[:, :, :, None, :]  # (B, t, T, band, 3)
        infl = _influence(offs, kp, sigma)  # (B, t, T, band, K)
        within = _membership_d2(q, p) <= r2  # (B, t, T, band)
        infl = torch.where(within[..., None], infl, 0.0)
        count[:, t0:t1] = torch.clamp(within.sum(-1), min=1).to(torch.int32)
        weighted[:, t0:t1] = torch.einsum(
            "xytbk,xybc->xytkc", _round(infl, dtype), _round(f, dtype)
        )
    return weighted.reshape(b, m, k_num, c), count.reshape(b, m)


def banded_maxpool(s_feats, q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
    """Max over in-reach band features (plain version); empty neighborhoods
    give 0.  Returns (B, M, C) in the dtype of ``s_feats``.
    (cofii2p_tpu/ops/banded.py:429-499)"""
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    r2 = r_active * r_active
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts)
    out = torch.empty(b, num_tiles, tile, c, dtype=s_feats.dtype, device=s_feats.device)
    neg = torch.tensor(float("-inf"), dtype=s_feats.dtype, device=s_feats.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * c):
        q, p, f = qt[:, t0:t1], pb[:, t0:t1], fb[:, t0:t1]
        within = _membership_d2(q, p) <= r2  # (B, t, T, band)
        pooled = torch.where(within[..., None], f[:, :, None], neg).amax(dim=3)
        out[:, t0:t1] = torch.where(within.any(-1, keepdim=True), pooled, 0.0)
    return out.reshape(b, m, c)


def banded_pair_count(q_points, s_points, r_active, tile=128, band_width=1024, starts=None):
    """(B, M) int64 number of in-reach band rows of each query: the
    unclamped in-reach count, i.e. the pairs a banded op must visit."""
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    qt, pb, _ = _tiles(q_points, s_points, None, tile, num_tiles, band, starts)
    r2 = float(np.float32(r_active * r_active))
    out = torch.empty(b, num_tiles, tile, dtype=torch.int64, device=q_points.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band):
        out[:, t0:t1] = (_membership_d2(qt[:, t0:t1], pb[:, t0:t1]) <= r2).sum(-1)
    return out.reshape(b, m)


# ---------------------------------------------------------------------------
# backward passes (plain versions of the transposed kernels)
# ---------------------------------------------------------------------------


def _starts_of(m, n, tile, num_tiles, band, b, device, starts):
    if starts is None:
        return static_starts(m, n, tile, band, num_tiles, b, device)
    return starts


def _scatter_add_bands(out: torch.Tensor, contrib: torch.Tensor, starts: torch.Tensor) -> None:
    """out (B, N, C) += each tile's band rows contrib (B, t, band, C),
    placed at the tiles' starts (B, t)."""
    b, nt, band, c = contrib.shape
    idx = (starts.long()[..., None] + torch.arange(band, device=out.device)).reshape(b, nt * band)
    out.scatter_add_(1, idx[..., None].expand(-1, -1, c), contrib.reshape(b, nt * band, c))


def banded_kpconv_aggregate_transpose(
    g_weighted, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32, starts=None,
):
    """Transposed banded aggregation (plain version): the gradient of
    :func:`banded_kpconv_aggregate` with respect to ``s_feats``,
    g_feats[j, c] = sum over queries m whose band holds j and whose reach
    holds j of sum_k infl_k(q_m, s_j) * g_weighted[m, k, c].

    Membership is the forward's: ``d2 <= r2`` centred on the first query
    of m's tile, and start(tile(m)) <= j < start(tile(m)) + band.  The
    influence and g are rounded to ``dtype``, as the TPU backward casts
    them (cofii2p_tpu/ops/kpconv_kernel.py:264-331, 479-522).

    g_weighted (B, M, K, C) -> (B, N, C) fp32.
    """
    b, m, k_num, c = g_weighted.shape
    n = s_points.shape[1]
    dev = q_points.device
    kp = torch.as_tensor(_load_kernel_points(radius, kernel_size), dtype=torch.float32, device=dev)
    r2 = kernel_reach(radius, sigma, kernel_size) ** 2
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    starts = _starts_of(m, n, tile, num_tiles, band, b, dev, starts)
    qt, pb, _ = _tiles(q_points, s_points, None, tile, num_tiles, band, starts)
    gt = g_weighted.reshape(b, num_tiles, tile, k_num, c)
    out = torch.zeros(b, n, c, dtype=torch.float32, device=dev)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * max(k_num, c)):
        q, p = qt[:, t0:t1], pb[:, t0:t1]
        offs = p[:, :, None, :, :] - q[:, :, :, None, :]  # (B, t, T, band, 3)
        infl = _influence(offs, kp, sigma)
        within = _membership_d2(q, p) <= r2
        infl = torch.where(within[..., None], infl, 0.0)
        contrib = torch.einsum("xytbk,xytkc->xybc", _round(infl, dtype), _round(gt[:, t0:t1], dtype))
        _scatter_add_bands(out, contrib, starts[:, t0:t1])
    return out


def _pool_tiles(s_feats, q_points, s_points, out, r_active, tile, band_width, starts):
    """Shared set-up of the maxpool backward passes: tiles, bands, the
    forward output per tile and every tile chunk's membership."""
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    starts = _starts_of(m, n, tile, num_tiles, band, b, q_points.device, starts)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts)
    ot = out.reshape(b, num_tiles, tile, c)
    r2 = r_active * r_active
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * c):
        within = _membership_d2(qt[:, t0:t1], pb[:, t0:t1]) <= r2  # (B, t, T, band)
        # (B, t, T, band, C): in reach and tied with the forward max
        tied = within[..., None] & (fb[:, t0:t1, None].float() == ot[:, t0:t1, :, None].float())
        yield t0, t1, starts, tied


def banded_maxpool_tie_count(s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024, starts=None):
    """Per (query, channel) count of in-reach band rows whose feature equals
    the forward max ``out`` (plain version of the tie-count pass,
    cofii2p_tpu/ops/maxpool_kernel.py:236-328).  Returns (B, M, C) fp32;
    0 where the neighbourhood is empty."""
    b, m, c = out.shape
    parts = [tied.sum(3).float() for *_, tied in _pool_tiles(
        s_feats, q_points, s_points, out, r_active, tile, band_width, starts)]
    return torch.cat(parts, dim=1).reshape(b, m, c)


def banded_maxpool_route(g_scaled, s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024, starts=None):
    """Routing of the maxpool backward (plain version of
    cofii2p_tpu/ops/maxpool_kernel.py::_maxpool_bwd_kernel): every in-reach
    band row j whose feature equals the forward max ``out[m, c]`` receives
    ``g_scaled[m, c]``.  The caller divides the cotangent by
    max(tie count, 1) first (maxpool_kernel.py:478-483), so ties split it
    evenly.  g_scaled (B, M, C) -> (B, N, C) fp32."""
    b, m, c = g_scaled.shape
    n = s_feats.shape[1]
    res = torch.zeros(b, n, c, dtype=torch.float32, device=g_scaled.device)
    g32 = g_scaled.float()
    for t0, t1, starts_, tied in _pool_tiles(s_feats, q_points, s_points, out, r_active, tile, band_width, starts):
        gt = g32.reshape(b, -1, tied.shape[2], c)[:, t0:t1, :, None]  # (B, t, T, 1, C)
        _scatter_add_bands(res, torch.where(tied, gt, 0.0).sum(2), starts_[:, t0:t1])
    return res


def bwd_geometry(m: int, n: int, tile_q: int, band: int, starts: np.ndarray, stile: int = 256):
    """Static plan of the transposed passes (a numpy copy of
    cofii2p_tpu/ops/kpconv_kernel.py:458-476): support tile size, tile
    count, the uniform query-window width (a multiple of tile_q) and each
    support tile's first query tile of that window.  A support tile's
    window holds every query tile whose static band touches it."""
    stile = min(stile, n)
    while n % stile:
        stile //= 2
    ns = n // stile
    t_lo = np.zeros(ns, np.int64)
    t_hi = np.zeros(ns, np.int64)
    for s_i in range(ns):
        touch = np.nonzero((starts < (s_i + 1) * stile) & (starts + band > s_i * stile))[0]
        if len(touch):
            t_lo[s_i], t_hi[s_i] = touch[0], touch[-1]
    q_win = int(((t_hi - t_lo + 1) * tile_q).max())
    q_win = min(-(-q_win // tile_q) * tile_q, m)
    qstart = np.minimum(t_lo * tile_q, m - q_win)
    return stile, ns, q_win, (qstart // tile_q).astype(np.int32)


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
    (cofii2p_tpu/ops/banded.py:96-190, ``center='best'``).

    For each query tile, the width-W window of support rows holding the most
    in-reach (query, row) pairs, estimated on every ``stride``-th support
    row.  As in the JAX package, the "has in-reach support" flag is taken
    over the sampled rows only, so a sparse tile may fall back to the
    static proportional start.  Returns (B, num_tiles) int32 starts clipped
    to [0, N - width].
    """
    if center != "best":
        raise NotImplementedError("the port implements center='best' (the config default)")
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    tile, num_tiles = _dyn_tile(m, tile)
    width = min(width, n)
    r2 = np.float32(np.float32(r_active * r_active) * np.float32(1.0001))
    s_sub = s_points[:, ::stride] if stride > 1 else s_points
    n_sub = s_sub.shape[1]
    w_sub = max(width // stride, 1)
    qt = q_points.reshape(b, num_tiles, tile, 3)
    out = torch.empty(b, num_tiles, dtype=torch.int64, device=q_points.device)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * n_sub):
        within = _membership_d2(qt[:, t0:t1], s_sub[:, None]) <= float(r2)  # (B, t, T, n_sub)
        wcnt = within.sum(dim=2)  # (B, t, n_sub)
        has = wcnt.sum(-1) > 0
        cs = torch.nn.functional.pad(torch.cumsum(wcnt, dim=-1), (1, 0))
        win = cs[..., w_sub:] - cs[..., : n_sub - w_sub + 1]
        dyn = torch.argmax(win, dim=-1) * stride
        t = torch.arange(t0, t1, device=q_points.device)
        static = ((2 * t * tile + tile) * n) // (2 * m) - width // 2
        out[:, t0:t1] = torch.where(has, dyn, static)
    return torch.clamp(out, 0, n - width).to(torch.int32)
