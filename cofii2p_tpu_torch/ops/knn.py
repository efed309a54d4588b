"""k-nearest-neighbour search on the device (counterpart of
cofii2p_tpu/ops/knn.py).

A blocked brute-force search: squared distances by the matmul identity
for a chunk of queries against the whole database, then the k smallest.
The JAX package runs it jitted, where XLA's CPU backend computes every
sum of three products as a chain of fused multiply-adds; the distances
here take the same chain (:func:`~cofii2p_tpu_torch.ops.geometry.fma_dot`,
float64-emulated), so they are bit-equal to JAX's on the CPU and need no
matmul, hence no TF32, on the card.

Ties follow ``lax.top_k``, the JAX search with ``approx=False``: on equal
distances the lower database index comes first, also at the k-th boundary,
which ``torch.topk`` does not promise.  JAX's ``approx=True``
(``lax.approx_min_k``, the JAX pyramid's default) finds the same distances
off the TPU but orders tied ones by its fallback sort, so on clouds with
duplicated points its maps can differ from these by rows at equal
distance; the port has no such mode.
"""

from __future__ import annotations

import torch

from cofii2p_tpu_torch.ops.geometry import fma_dot, gather_neighbors

# elements of one chunk's (B, queries, database) distance block
_CHUNK_ELEMS = 1 << 26


def sq_dist_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances,
    ||a||^2 + ||b||^2 - 2<a, b> with each term a fused chain, as the
    jitted cofii2p_tpu/ops/geometry.py::pairwise_sq_dist(clamp=False)."""
    sa, sb = fma_dot(a, a), fma_dot(b, b)
    inner = fma_dot(a[..., :, None, :], b[..., None, :, :])
    return (sa[..., :, None] + sb[..., None, :]) - 2.0 * inner


def _chunks(queries: torch.Tensor, database: torch.Tensor, query_chunk: int):
    lead = queries.shape[:-2].numel()
    nq, nd = queries.shape[-2], database.shape[-2]
    step = max(1, min(query_chunk, _CHUNK_ELEMS // max(lead * nd, 1)))
    for q0 in range(0, nq, step):
        yield q0, sq_dist_fma(queries[..., q0:q0 + step, :], database)


def _kth_value(d2: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest entry (..., 1) of each row of d2."""
    return torch.topk(d2, k, dim=-1, largest=False, sorted=False).values.amax(-1, keepdim=True)


def _k_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) of the k smallest entries of each row of d2, in
    ascending index order; of entries tied at the k-th value the lowest
    indices are taken."""
    return _take_lowest(d2, _kth_value(d2, k), k)


def _take_lowest(d2: torch.Tensor, kth: torch.Tensor, k: int) -> torch.Tensor:
    """The entries below ``kth`` and, of those equal to it, the lowest
    indices, k a row, in ascending index order."""
    less = d2 < kth
    tied = d2 == kth
    room = k - less.sum(-1, keepdim=True)
    take = less | (tied & (torch.cumsum(tied, dim=-1, dtype=torch.int32) <= room))
    return take.nonzero()[:, -1].reshape(*d2.shape[:-1], k)


def knn_index_order(queries: torch.Tensor, database: torch.Tensor, k: int, query_chunk: int = 2048) -> torch.Tensor:
    """The k nearest database points of each query, sorted by index (the
    pyramid's ``neighbors`` and ``subsampling`` maps, pyramid.py:150-162):
    (..., Nq, 3), (..., Nd, 3) -> (..., Nq, k) int64."""
    return torch.cat([_k_smallest(d2, k) for _, d2 in _chunks(queries, database, query_chunk)], dim=-2)


def knn(queries: torch.Tensor, database: torch.Tensor, k: int, query_chunk: int = 2048) -> torch.Tensor:
    """Indices (..., Nq, k) int64 of the k nearest database points of each
    query, by ascending distance, lower index first on ties; a query that
    is a database point finds itself first.  JAX's search with
    ``approx=False`` (cofii2p_tpu/ops/knn.py:33-78); its ``approx=True``
    orders tied distances otherwise (module docstring)."""
    parts = []
    for _, d2 in _chunks(queries, database, query_chunk):
        idx = _k_smallest(d2, k)
        order = torch.sort(torch.gather(d2, -1, idx), dim=-1, stable=True).indices
        parts.append(torch.gather(idx, -1, order))
    return torch.cat(parts, dim=-2)


def knn_with_distances(queries: torch.Tensor, database: torch.Tensor, k: int,
                       query_chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn` and the squared distances (..., Nq, k) to the neighbours
    found (cofii2p_tpu/ops/knn.py:81-86)."""
    idx = knn(queries, database, k, query_chunk)
    return idx, ((queries[..., :, None, :] - gather_neighbors(database, idx)) ** 2).sum(-1)
