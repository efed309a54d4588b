"""KITTI data-recipe utilities (a numpy copy of
cofii2p_tpu/data/kitti_utils.py).

Capability match for the reference's helper grab-bag
(reference data/kitti_helper.py): camera<->NWU coordinate swaps,
image-frustum point cropping, projection overlays, and approximate FPS via
voxel seeding.  Calibration parsing lives in data/calib.py, voxel
downsampling in data/voxel.py + native/, exact FPS in native/.
"""

from __future__ import annotations

import numpy as np


def cam_to_nwu(pc: np.ndarray) -> np.ndarray:
    """Camera frame (x right, y down, z forward) -> NWU (x fwd, y left, z up).
    pc: (N, 3)."""
    out = np.empty_like(pc)
    out[:, 0] = pc[:, 2]
    out[:, 1] = -pc[:, 0]
    out[:, 2] = -pc[:, 1]
    return out


def nwu_to_cam(pc: np.ndarray) -> np.ndarray:
    out = np.empty_like(pc)
    out[:, 0] = -pc[:, 1]
    out[:, 1] = -pc[:, 2]
    out[:, 2] = pc[:, 0]
    return out


def crop_pc_to_image(
    pc: np.ndarray, attrs: np.ndarray | None, img_hw: tuple, K: np.ndarray
):
    """Keep points whose projection lands inside the image and in front of
    the camera (reference crop_pc_with_img)."""
    h, w = img_hw
    uvz = pc @ K.T
    z = uvz[:, 2]
    uv = uvz[:, :2] / np.maximum(z[:, None], 1e-12)
    keep = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] <= w - 1) & (uv[:, 1] >= 0) & (
        uv[:, 1] <= h - 1
    )
    return pc[keep], (None if attrs is None else attrs[keep]), keep


def project_points_to_image(
    img: np.ndarray, pc: np.ndarray, K: np.ndarray, size: int = 2
) -> np.ndarray:
    """Splat projected points onto an image copy, colored by inverse depth
    (reference projection_pc_img / draw_points_on_img, as pure NumPy)."""
    out = img.copy()
    h, w = img.shape[:2]
    uvz = pc @ K.T
    z = uvz[:, 2]
    front = z > 0
    uv = np.round(uvz[front, :2] / z[front, None]).astype(np.int64)
    z = z[front]
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    uv, z = uv[ok], z[ok]
    heat = np.clip(1.0 / np.maximum(z, 1e-3), 0, 1)
    for (x, y), c in zip(uv, heat):
        y0, y1 = max(y - size, 0), min(y + size + 1, h)
        x0, x1 = max(x - size, 0), min(x + size + 1, w)
        out[y0:y1, x0:x1, 0] = c if out.dtype.kind == "f" else int(255 * c)
        out[y0:y1, x0:x1, 1:] = 0
    return out


def fps_approximate(pc: np.ndarray, voxel_size: float, num: int) -> np.ndarray:
    """Approximate farthest-point sampling: voxel downsample to thin the
    cloud, then exact FPS on the survivors (reference fps_approximate)."""
    from cofii2p_tpu_torch.native import farthest_point_sampling, voxel_downsample

    thinned, _ = voxel_downsample(pc, None, voxel_size)
    if thinned.shape[0] <= num:
        thinned = pc
    idx = farthest_point_sampling(thinned, min(num, thinned.shape[0]))
    return thinned[idx]
