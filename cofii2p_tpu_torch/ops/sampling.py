"""Farthest point sampling and k-NN feature interpolation (counterpart of
cofii2p_tpu/ops/sampling.py)."""

from __future__ import annotations

from typing import Optional

import torch

from cofii2p_tpu_torch.ops.geometry import fma_dot, gather_neighbors


def farthest_point_sampling(points: torch.Tensor, k: int, first=None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Indices (k,) int64 of k farthest-point samples (greedy max-min) of
    points (N, 3), from the start index ``first``, or one drawn from
    ``generator`` (cofii2p_tpu/ops/sampling.py:20-46; JAX draws the start
    from its key).  Distances are summed as the jitted JAX loop sums them;
    argmax takes the first maximum."""
    n = points.shape[0]
    if first is None:
        first = torch.randint(0, n, (), generator=generator, device=points.device)
    first = torch.as_tensor(first, device=points.device).long()
    idxs = torch.empty(k, dtype=torch.long, device=points.device)
    idxs[0] = first
    diff = points - points[first]
    dists = fma_dot(diff, diff)
    for i in range(1, k):
        nxt = torch.argmax(dists)
        idxs[i] = nxt
        diff = points - points[nxt]
        dists = torch.minimum(dists, fma_dot(diff, diff))
    return idxs


def knn_interpolate(s_feats: torch.Tensor, q_points: torch.Tensor, s_points: torch.Tensor,
                    neighbor_indices: torch.Tensor, k: int, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-squared-distance interpolation of s_feats (..., M, C) at
    q_points (..., N, 3) from each query's first k neighbour indices
    (..., N, >=k) into s_points (..., M, 3); shadow indices (== M) weigh
    nothing.  Returns (..., N, C).  (cofii2p_tpu/ops/sampling.py:49-72)"""
    m = s_feats.shape[-2]
    idx = neighbor_indices[..., :k]
    sq = ((q_points[..., :, None, :] - gather_neighbors(s_points, idx)) ** 2).sum(-1)
    w = (idx < m).to(s_feats.dtype) / (sq + eps)
    w = w / (w.sum(-1, keepdim=True) + eps)
    return (gather_neighbors(s_feats, idx) * w[..., None]).sum(-2)


def global_avgpool(feats: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of feats (..., N, C) over the points, over the valid ones when
    a mask (..., N) is given -> (..., C).  (sampling.py:75-86)"""
    if valid_mask is None:
        return feats.mean(-2)
    w = valid_mask.to(feats.dtype)
    return (feats * w[..., None]).sum(-2) / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
