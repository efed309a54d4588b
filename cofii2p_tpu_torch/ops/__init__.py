"""Geometry, banded neighborhood ops and the CUDA kernels' wrappers (torch).

The package exports the names of cofii2p_tpu/ops/__init__.py.  Importing
it builds nothing and loads no kernel module.
"""

from cofii2p_tpu_torch.ops.geometry import (
    apply_se3,
    euler_to_rotation,
    index_select,
    inverse_se3,
    pairwise_sq_dist,
    point2node,
    rodrigues,
    rotation_to_rodrigues,
    se3_from_rt,
)
from cofii2p_tpu_torch.ops.knn import knn
from cofii2p_tpu_torch.ops.patch import extract_patches
from cofii2p_tpu_torch.ops.pyramid import build_pyramid
from cofii2p_tpu_torch.ops.subsample import grid_subsample, radius_search

__all__ = [
    "apply_se3",
    "euler_to_rotation",
    "index_select",
    "inverse_se3",
    "pairwise_sq_dist",
    "point2node",
    "rodrigues",
    "rotation_to_rodrigues",
    "se3_from_rt",
    "knn",
    "build_pyramid",
    "grid_subsample",
    "radius_search",
    "extract_patches",
]
