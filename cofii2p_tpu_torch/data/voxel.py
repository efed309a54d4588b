"""Host-side NumPy voxel downsampling and fixed-size resampling (a numpy
copy of cofii2p_tpu/data/voxel.py).

Replaces the reference's Open3D C++ calls in the loader
(reference data/kitti.py:148-180): voxel_down_sample with per-voxel
averaged attributes, then resample to exactly ``num_pc`` points.  The KITTI
loader voxelises with the native host ops (cofii2p_tpu_torch/native), whose
voxel order differs from this one; the nuScenes builder uses this one.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample(
    points: np.ndarray, attrs: np.ndarray | None, voxel_size: float
) -> tuple[np.ndarray, np.ndarray | None]:
    """Average points (and attrs) per occupied voxel.

    Args:
      points: (N, 3).
      attrs: optional (N, A) extra channels (intensity, normals).
      voxel_size: grid pitch (reference uses 0.1 m, kitti.py:283).

    Returns (points (M, 3), attrs (M, A) or None), M = number of voxels, in
    lexicographic order of the voxel coordinates.
    """
    coords = np.floor(points / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(
        coords, axis=0, return_inverse=True, return_counts=True
    )
    m = counts.shape[0]
    out_pts = np.zeros((m, 3), np.float64)
    np.add.at(out_pts, inverse, points)
    out_pts /= counts[:, None]
    out_attrs = None
    if attrs is not None:
        out_attrs = np.zeros((m, attrs.shape[1]), np.float64)
        np.add.at(out_attrs, inverse, attrs)
        out_attrs /= counts[:, None]
        out_attrs = out_attrs.astype(np.float32)
    return out_pts.astype(np.float32), out_attrs


def resample_fixed(
    points: np.ndarray,
    attrs: np.ndarray | None,
    num: int,
    rng: np.random.RandomState,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Resample to exactly ``num`` points: random subset when larger, repeat
    + random fill when smaller (reference downsample_np, kitti.py:168-180)."""
    n = points.shape[0]
    if n >= num:
        choice = rng.choice(n, num, replace=False)
    else:
        fix = np.arange(n)
        while n + fix.shape[0] < num:
            fix = np.concatenate([fix, np.arange(n)])
        rand = rng.choice(n, num - fix.shape[0], replace=False)
        choice = np.concatenate([fix, rand])
    return points[choice], None if attrs is None else attrs[choice]
