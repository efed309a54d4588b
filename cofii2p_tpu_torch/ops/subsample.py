"""Fixed-shape voxel-grid subsampling and radius search (counterpart of
cofii2p_tpu/ops/subsample.py).

``grid_subsample`` averages the points (and attributes) of each occupied
voxel into a static number of output slots with a validity mask;
``radius_search`` is a fixed-size k-NN with the entries beyond the radius
set to the shadow index len(database).
"""

from __future__ import annotations

import numpy as np
import torch

from cofii2p_tpu_torch.ops.geometry import fma_dot, gather_neighbors
from cofii2p_tpu_torch.ops.knn import knn


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the last key is the primary one; stable."""
    order = torch.sort(keys[0], stable=True).indices
    for key in keys[1:]:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def grid_subsample(points: torch.Tensor, voxel_size: float, max_points: int, valid_mask=None, attributes=None):
    """Voxel-grid downsample with per-voxel means at a fixed output size
    (cofii2p_tpu/ops/subsample.py:26-90).

    points (N, 3); valid_mask (N,) bool, False rows ignored; attributes
    (N, A) averaged alongside.  Voxels come out in (x, y, z) voxel order;
    those past ``max_points`` are dropped.  Returns (points (max_points, 3),
    attributes (max_points, A) or None, valid (max_points,) bool).
    """
    n = points.shape[0]
    dev = points.device
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=dev)
    coords = torch.floor(points / np.float32(voxel_size)).to(torch.int32)
    coords = torch.where(valid_mask[:, None], coords, torch.iinfo(torch.int32).max)  # invalid rows last
    order = _lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    key_s, valid_s = coords[order], valid_mask[order]
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), (key_s[1:] != key_s[:-1]).any(-1)])
    seg_id = torch.cumsum(new_seg.to(torch.int32), 0) - 1
    slot = torch.where(valid_s & (seg_id < max_points), seg_id, max_points).long()  # the last slot is trash
    sums = torch.zeros(max_points + 1, 3, dtype=points.dtype, device=dev).index_add_(0, slot, points[order])
    cnts = torch.zeros(max_points + 1, dtype=points.dtype, device=dev).index_add_(
        0, slot, torch.ones(n, dtype=points.dtype, device=dev))
    denom = torch.clamp(cnts[:max_points, None], min=1.0)
    out_attrs = None
    if attributes is not None:
        asums = torch.zeros(max_points + 1, attributes.shape[-1], dtype=attributes.dtype, device=dev)
        out_attrs = asums.index_add_(0, slot, attributes[order])[:max_points] / denom
    return sums[:max_points] / denom, out_attrs, cnts[:max_points] > 0


def radius_search(queries: torch.Tensor, database: torch.Tensor, radius: float, max_neighbors: int) -> torch.Tensor:
    """(Nq, max_neighbors) int64 indices of each query's nearest database
    points, those beyond ``radius`` set to len(database), the shadow index
    KPConv masks (cofii2p_tpu/ops/subsample.py:93-103).  The distances are
    summed as the jitted JAX function sums them (a fused chain)."""
    idx = knn(queries, database, max_neighbors)
    diff = queries[..., :, None, :] - gather_neighbors(database, idx)
    r = np.float32(radius)
    return torch.where(fma_dot(diff, diff) <= r * r, idx, database.shape[-2])
