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
import torch.utils.checkpoint

# elements of the largest intermediate one chunk of tiles may hold; bounds
# the plain versions' memory at KITTI scale
_CHUNK_ELEMS = 1 << 26


def _load_kernel_points(radius: float, kernel_size: int) -> np.ndarray:
    # imported here: the models package imports this module, so a
    # module-level import would make ops and models import each other
    from cofii2p_tpu_torch.models.kernel_points import load_kernel_points

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


def _nearest_k(d2: torch.Tensor, kk: int, approx: bool = False):
    """Negated d2 and indices (..., kk) of the kk nearest rows along the
    last axis, nearest first, the lower index first among equal distances:
    ``lax.top_k(-d2, kk)`` (cofii2p_tpu/ops/banded.py:502-515), by a stable
    sort, since ``torch.topk`` promises no order among ties.  ``approx``
    is accepted and selects exactly, as the JAX package's CPU lowering of
    ``approx_max_k`` does."""
    del approx
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return -d2s[..., :kk], idx[..., :kk]


def _membership_d2_rows(q: torch.Tensor, p_rows: torch.Tensor) -> torch.Tensor:
    """:func:`_membership_d2` for gathered per-query rows: q (..., T, 3),
    p_rows (..., T, S, 3) -> (..., T, S), with the same centring on the
    tile's first query and per-dimension op order, so a gathered recompute
    is bit-equal to the full-band d2 at the gathered positions
    (cofii2p_tpu/ops/banded.py:280-292)."""
    ref = q[..., 0:1, :]
    qc = q - ref
    pc = p_rows - ref[..., None, :]
    d2 = None
    for d in range(3):
        diff = qc[..., :, None, d] - pc[..., d]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Band rows by band-local index: x (B, t, band, D), idx (B, t, T, k)
    -> (B, t, T, k, D); differentiable in ``x`` (a scatter-add back)."""
    b, t, tq, k = idx.shape
    d = x.shape[-1]
    flat = idx.reshape(b, t, tq * k, 1).expand(-1, -1, -1, d)
    return torch.gather(x, 2, flat).reshape(b, t, tq, k, d)


def _checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward rather than saved when
    autograd records it: the counterpart of the JAX package's
    ``jax.checkpoint(tile_fn)`` (banded.py:647, :766), which keeps a tile
    chunk's gathered rows and influence out of the saved tensors."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _static_tiles(q_points, s_points, s_feats, tile, band_width):
    """(tile, num_tiles, band, query tiles, point bands, feature bands) of
    the static band plan; the compacted ops take no dynamic starts."""
    m, n = q_points.shape[1], s_points.shape[1]
    tile, num_tiles, band = band_plan(m, n, tile, band_width)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, None)
    return tile, num_tiles, band, qt, pb, fb


def banded_knn_select(q_points, s_points, k=128, tile=128, band_width=1024, approx=False):
    """Band-local indices (B, M, kk) int64 of each query's kk = min(k, band)
    nearest band rows, nearest first, the lower band index first among
    equal distances (cofii2p_tpu/ops/banded.py:518-563).  Every compacted
    consumer of a (query level, support level) pair shares one selection:
    the first j columns are the j-nearest selection, so a consumer with a
    smaller k slices ``rel[..., :j]``.  Indices count from each tile's
    static band start."""
    b, m = q_points.shape[:2]
    tile, num_tiles, band, qt, pb, _ = _static_tiles(q_points, s_points, None, tile, band_width)
    kk = min(k, band)
    parts = []
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band):
        parts.append(_nearest_k(_membership_d2(qt[:, t0:t1], pb[:, t0:t1]), kk, approx)[1])
    return torch.cat(parts, dim=1).reshape(b, m, kk)


def banded_compact_maxpool(s_feats, q_points, s_points, r_active, k=128, tile=128, band_width=1024, knn=False,
                           approx=False, rel=None):
    """Max over each query's <= k nearest band members (plain PyTorch;
    cofii2p_tpu/ops/banded.py:566-655): the k nearest band rows are
    selected (or read from ``rel``, (B, M, j) band-local indices from
    :func:`banded_knn_select` on the same plan), gathered and maxed.

    ``knn=False``: the members are the selected rows within ``r_active``,
    so the result is :func:`banded_maxpool`'s wherever the in-reach count
    is <= k, and 0 where no selected row is in reach.  ``knn=True``: the
    members are the k nearest, with no radius mask (the reference's k-NN
    maxpool).  The max's gradient is split evenly among tied maxima, as
    JAX differentiates ``jnp.max``.  Returns (B, M, C) in s_feats' dtype.
    """
    b, m = q_points.shape[:2]
    c = s_feats.shape[-1]
    r2 = r_active * r_active
    tile, num_tiles, band, qt, pb, fb = _static_tiles(q_points, s_points, s_feats, tile, band_width)
    kk = min(k, band) if rel is None else rel.shape[-1]
    rt = None if rel is None else rel.reshape(b, num_tiles, tile, kk).long()
    neg = torch.tensor(float("-inf"), dtype=s_feats.dtype, device=s_feats.device)

    def pool(q, p, f, rel_t):
        if rel_t is None:
            negk, idx = _nearest_k(_membership_d2(q, p), kk, approx)
            d2k = -negk
        else:
            idx, d2k = rel_t, None
        rows = _take_rows(f, idx)  # (B, t, T, kk, C)
        if knn:
            return rows.amax(3) if kk else torch.zeros(*q.shape[:-1], c, dtype=f.dtype, device=f.device)
        if d2k is None:
            d2k = _membership_d2_rows(q, _take_rows(p, idx))
        member = d2k <= r2  # (B, t, T, kk)
        out = torch.where(member[..., None], rows, neg).amax(3)
        return torch.where(member.any(-1, keepdim=True), out, 0.0)

    parts = []
    for t0, t1 in _tile_chunks(num_tiles, b * tile * max(band, kk * c)):
        parts.append(_checkpointed(pool, qt[:, t0:t1], pb[:, t0:t1], fb[:, t0:t1],
                                   None if rt is None else rt[:, t0:t1]))
    return torch.cat(parts, dim=1).reshape(b, m, c)


def banded_compact_aggregate(s_feats, q_points, s_points, radius, sigma, kernel_size=15, k=128, tile=128,
                             band_width=1024, dtype=torch.float32, knn=False, kp=None, approx=False, rel=None):
    """KPConv aggregation over each query's <= k nearest band members
    (plain PyTorch; cofii2p_tpu/ops/banded.py:658-768): the rows are
    selected as in :func:`banded_compact_maxpool`, gathered, and
    weighted[m, k, c] = sum over them of infl_k(q_m, s_j) * s_feats[j, c].

    ``knn=False`` (radius): members are the selected rows within kernel
    reach; ``count`` is the uncapped in-reach count over the whole band,
    so the result is :func:`banded_kpconv_aggregate`'s wherever that count
    is <= k.  ``knn=True``: members are the k nearest rows with no reach
    mask, and ``count`` the reference's active-row rule, the gathered rows
    whose features sum to more than 0; with ``rel`` given no full-band d2
    is computed.  ``kp`` (K, 3): the layer's own kernel points (else the
    canonical disposition).  The influence and the features are rounded to
    ``dtype`` and multiplied in fp32 (JAX's bf16 contraction with fp32
    output).  Returns weighted (B, M, K, C) fp32 and count (B, M) int32.
    """
    b, m = q_points.shape[:2]
    c = s_feats.shape[-1]
    dev = q_points.device
    if kp is None:
        kp = torch.as_tensor(_load_kernel_points(radius, kernel_size), dtype=torch.float32, device=dev)
        r2 = kernel_reach(radius, sigma, kernel_size) ** 2
    else:
        kp = kp.to(device=dev, dtype=torch.float32)
        r2 = tau_reach2(radius, sigma, kernel_size)
    k_num = kp.shape[0]
    tile, num_tiles, band, qt, pb, fb = _static_tiles(q_points, s_points, s_feats, tile, band_width)
    kk = min(k, band) if rel is None else rel.shape[-1]
    rt = None if rel is None else rel.reshape(b, num_tiles, tile, kk).long()

    def aggregate(q, p, f, rel_t):
        d2full = _membership_d2(q, p) if rel_t is None or not knn else None
        idx = _nearest_k(d2full, kk, approx)[1] if rel_t is None else rel_t
        p_rows, f_rows = _take_rows(p, idx), _take_rows(f, idx)
        infl = _influence(p_rows - q[..., None, :], kp, sigma)  # (B, t, T, kk, K)
        if knn:
            count = (f_rows.float().sum(-1) > 0.0).sum(-1)
        else:
            within = _membership_d2_rows(q, p_rows) <= r2
            infl = torch.where(within[..., None], infl, 0.0)
            count = (d2full <= r2).sum(-1)  # uncapped, as the full-band aggregate
        weighted = torch.einsum("xytqk,xytqc->xytkc", _round(infl, dtype), _round(f_rows, dtype))
        return weighted, torch.clamp(count, min=1).to(torch.int32)

    ws, cs = [], []
    for t0, t1 in _tile_chunks(num_tiles, b * tile * max(band, kk * max(k_num, c))):
        w, cnt = _checkpointed(aggregate, qt[:, t0:t1], pb[:, t0:t1], fb[:, t0:t1],
                               None if rt is None else rt[:, t0:t1])
        ws.append(w)
        cs.append(cnt)
    return torch.cat(ws, dim=1).reshape(b, m, k_num, c), torch.cat(cs, dim=1).reshape(b, m)


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


# ---------------------------------------------------------------------------
# backward passes (plain versions of the transposed kernels)
# ---------------------------------------------------------------------------


def _starts_of(m, n, tile, num_tiles, band, b, device, starts):
    if starts is None:
        return static_starts(m, n, tile, band, num_tiles, b, device)
    return starts


def _scatter_add_bands(out: torch.Tensor, contrib: torch.Tensor, starts: torch.Tensor) -> None:
    """out (B, N, C) += each tile's band rows contrib (B, t, band, C),
    placed at the tiles' starts (B, t), one tile after the other: a row's
    sum runs in tile order, as cofii2p_tpu/ops/kpconv_kernel.py::
    _scatter_band_stacks adds overlapping windows, on the card as well."""
    b, nt, band, c = contrib.shape
    rows = torch.arange(band, device=out.device)
    for t in range(nt):
        idx = (starts[:, t].long()[:, None] + rows)[..., None].expand(-1, -1, c)
        out.scatter_add_(1, idx, contrib[:, t])


def scatter_band_stacks(stack: torch.Tensor, starts: torch.Tensor, n: int) -> torch.Tensor:
    """Per-tile window gradients stack (B, nt, band, C) fp32 and their
    starts (B, nt) -> (B, N, C) fp32, the windows added in tile order
    (plain version of the scatter of kernels #10 and #14)."""
    b, _, _, c = stack.shape
    out = torch.zeros(b, n, c, dtype=torch.float32, device=stack.device)
    _scatter_add_bands(out, stack.float(), starts)
    return out


def banded_kpconv_aggregate_transpose(
    g_weighted, q_points, s_points, radius, sigma, kernel_size=15, tile=128,
    band_width=1024, dtype=torch.float32, starts=None, tau=None, kp=None,
):
    """Transposed banded aggregation (plain version): the gradient of
    :func:`banded_kpconv_aggregate` with respect to ``s_feats``,
    g_feats[j, c] = sum over queries m whose band holds j and whose reach
    holds j of sum_k infl_k(q_m, s_j) * g_weighted[m, k, c].

    Membership is the forward's: ``d2 <= r2`` centred on the first query
    of m's tile, and start(tile(m)) <= j < start(tile(m)) + band.  The
    influence and g are rounded to ``dtype``, as the TPU backward casts
    them (cofii2p_tpu/ops/kpconv_kernel.py:264-331, 479-522).  ``starts``
    (B, nt): the forward's dynamic windows, whose overlaps add in tile
    order (kpconv_kernel.py:334-456).  ``tau`` (B, M) and ``kp`` (K, 3):
    the k-NN semantics, membership (d2 <= :func:`tau_reach2`) & (d2 <=
    tau[m]) and the layer's own kernel points (kpconv_kernel.py:731-846).

    g_weighted (B, M, K, C) -> (B, N, C) fp32.
    """
    b, m, k_num, c = g_weighted.shape
    n = s_points.shape[1]
    dev = q_points.device
    if kp is None:
        kp = torch.as_tensor(_load_kernel_points(radius, kernel_size), dtype=torch.float32, device=dev)
        r2 = kernel_reach(radius, sigma, kernel_size) ** 2
    else:
        kp = kp.to(device=dev, dtype=torch.float32)
        r2 = tau_reach2(radius, sigma, kernel_size)
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    starts = _starts_of(m, n, tile, num_tiles, band, b, dev, starts)
    qt, pb, _ = _tiles(q_points, s_points, None, tile, num_tiles, band, starts)
    gt = g_weighted.reshape(b, num_tiles, tile, k_num, c)
    tt = None if tau is None else tau.reshape(b, num_tiles, tile, 1)
    out = torch.zeros(b, n, c, dtype=torch.float32, device=dev)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * max(k_num, c)):
        q, p = qt[:, t0:t1], pb[:, t0:t1]
        offs = p[:, :, None, :, :] - q[:, :, :, None, :]  # (B, t, T, band, 3)
        infl = _influence(offs, kp, sigma)
        d2 = _membership_d2(q, p)
        within = d2 <= r2 if tt is None else (d2 <= r2) & (d2 <= tt[:, t0:t1])
        infl = torch.where(within[..., None], infl, 0.0)
        contrib = torch.einsum("xytbk,xytkc->xybc", _round(infl, dtype), _round(gt[:, t0:t1], dtype))
        _scatter_add_bands(out, contrib, starts[:, t0:t1])
    return out


def _pool_tiles(s_feats, q_points, s_points, out, r_active, tile, band_width, starts, tau=None):
    """Shared set-up of the maxpool backward passes: tiles, bands, the
    forward output per tile and every tile chunk's membership, d2 <=
    r_active² or, with ``tau`` (B, M), d2 <= tau[m]."""
    b, m = q_points.shape[:2]
    n, c = s_feats.shape[1:]
    tile, num_tiles, band = band_plan(m, n, tile, band_width, starts)
    starts = _starts_of(m, n, tile, num_tiles, band, b, q_points.device, starts)
    qt, pb, fb = _tiles(q_points, s_points, s_feats, tile, num_tiles, band, starts)
    ot = out.reshape(b, num_tiles, tile, c)
    thr = r_active * r_active if tau is None else tau.reshape(b, num_tiles, tile, 1)
    for t0, t1 in _tile_chunks(num_tiles, b * tile * band * c):
        within = _membership_d2(qt[:, t0:t1], pb[:, t0:t1]) <= (thr if tau is None else thr[:, t0:t1])
        # (B, t, T, band, C): a member and tied with the forward max
        tied = within[..., None] & (fb[:, t0:t1, None].float() == ot[:, t0:t1, :, None].float())
        yield t0, t1, starts, tied


def banded_maxpool_tie_count(s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024, starts=None,
                             tau=None):
    """Per (query, channel) count of in-reach band rows whose feature equals
    the forward max ``out`` (plain version of the tie-count pass,
    cofii2p_tpu/ops/maxpool_kernel.py:236-328); with ``tau`` (B, M) the
    members are the rows with d2 <= tau[m] and ``r_active`` is unused.
    Returns (B, M, C) fp32; 0 where the neighbourhood is empty."""
    b, m, c = out.shape
    parts = [tied.sum(3).float() for *_, tied in _pool_tiles(
        s_feats, q_points, s_points, out, r_active, tile, band_width, starts, tau)]
    return torch.cat(parts, dim=1).reshape(b, m, c)


def banded_maxpool_route(g_scaled, s_feats, q_points, s_points, out, r_active, tile=128, band_width=1024, starts=None,
                         tau=None):
    """Routing of the maxpool backward (plain version of
    cofii2p_tpu/ops/maxpool_kernel.py::_maxpool_bwd_kernel, and with
    ``starts`` of _mp_bwd_dyn_kernel, with ``tau`` of
    _maxpool_bwd_kernel_tau): every member band row j whose feature equals
    the forward max ``out[m, c]`` receives ``g_scaled[m, c]``.  The caller
    divides the cotangent by max(tie count, 1) first
    (maxpool_kernel.py:478-483), so ties split it evenly.  g_scaled
    (B, M, C) -> (B, N, C) fp32."""
    b, m, c = g_scaled.shape
    n = s_feats.shape[1]
    res = torch.zeros(b, n, c, dtype=torch.float32, device=g_scaled.device)
    g32 = g_scaled.float()
    for t0, t1, starts_, tied in _pool_tiles(s_feats, q_points, s_points, out, r_active, tile, band_width, starts,
                                             tau):
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


def dynamic_knn_starts(q_points, s_points, tau, tile=128, width=256, stride=1):
    """Per-tile window starts under k-NN semantics (cofii2p_tpu/ops/
    banded.py:193-244): as :func:`dynamic_band_starts`, with membership
    ``d2 <= tau[m]`` per query.  tau (B, M) -> (B, num_tiles) int32."""
    b, m = q_points.shape[:2]
    tt = tau.reshape(b, -1, _dyn_tile(m, tile)[0], 1)
    return _best_windows(q_points, s_points, lambda t0, t1: tt[:, t0:t1], tile, width, stride)


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


def band_coverage(q_points, s_points, radius, sigma, kernel_size=15, tile=128, band_width=1024) -> dict:
    """Host diagnostic (NumPy, float64) of one frame: the share of
    in-reach (query, support) pairs, and of their influence mass, that the
    static band plan keeps; 1.0 means the banded op equals the full
    radius-neighbourhood op on this cloud (cofii2p_tpu/ops/banded.py:891-935).
    q_points (M, 3), s_points (N, 3)."""
    q = np.asarray(q_points, np.float64)
    s = np.asarray(s_points, np.float64)
    m, n = len(q), len(s)
    r = kernel_reach(radius, sigma, kernel_size)
    tile, num_tiles, band, dense = _band_geometry(m, n, tile, band_width)
    if dense:
        return {"pair_coverage": 1.0, "mass_coverage": 1.0, "band": band}

    d2 = ((q[:, None, :] - s[None, :, :]) ** 2).sum(-1)  # (M, N)
    within = d2 <= r * r
    kp = _load_kernel_points(radius, kernel_size)
    dk = np.sqrt(np.maximum(d2[..., None] - 2.0 * (q[:, None, :] - s[None, :, :]) @ kp.T + (kp**2).sum(-1), 0.0))
    mass = np.maximum(1.0 - dk / sigma, 0.0).sum(-1) * within  # (M, N)

    t_idx = np.arange(m) // tile
    centers = ((2 * t_idx * tile + tile) * n) // (2 * m)
    starts = np.clip(centers - band // 2, 0, n - band)
    j = np.arange(n)[None, :]
    in_band = (j >= starts[:, None]) & (j < starts[:, None] + band)

    pairs = within.sum()
    return {
        "pair_coverage": float((within & in_band).sum() / max(pairs, 1)),
        "mass_coverage": float((mass * in_band).sum() / max(mass.sum(), 1e-12)),
        "band": band,
    }
