"""Host-side augmentations: random SE(3) perturbations, colour jitter and
the intrinsics bookkeeping of a crop or a scale (a numpy copy of
cofii2p_tpu/data/augment.py).

The reference's augmentation surface (reference data/kitti.py:193-238):
a uniform random pose perturbation with per-axis amplitudes (R = Rz Ry Rx)
applied to the cloud, and torchvision-style ColorJitter
(brightness/contrast/saturation/hue in random order) on the image.  The
random SE(3) perturbation applies during evaluation too; that is the
published protocol (BASELINE.md).
"""

from __future__ import annotations

import numpy as np


def random_se3(rng: np.random.RandomState, amplitudes: dict) -> np.ndarray:
    """Uniform random perturbation, R = Rz Ry Rx (reference kitti.py:217-238).
    amplitudes keys: tx, ty, tz, rx, ry, rz."""
    t = np.array(
        [
            rng.uniform(-amplitudes["tx"], amplitudes["tx"]),
            rng.uniform(-amplitudes["ty"], amplitudes["ty"]),
            rng.uniform(-amplitudes["tz"], amplitudes["tz"]),
        ],
        np.float32,
    )
    ax = rng.uniform(-amplitudes["rx"], amplitudes["rx"])
    ay = rng.uniform(-amplitudes["ry"], amplitudes["ry"])
    az = rng.uniform(-amplitudes["rz"], amplitudes["rz"])
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = (Rz @ Ry @ Rx).astype(np.float32)
    P[:3, 3] = t
    return P


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return img @ np.array([0.299, 0.587, 0.114], img.dtype)


def color_jitter(
    img: np.ndarray,
    rng: np.random.RandomState,
    brightness=(0.8, 1.2),
    contrast=(0.8, 1.2),
    saturation=(0.8, 1.2),
    hue=(-0.1, 0.1),
) -> np.ndarray:
    """torchvision-style ColorJitter on a float [0,1] HWC image, applied in a
    random order (reference augment_img ranges, kitti.py:193-202)."""
    ops = list(range(4))
    rng.shuffle(ops)
    for op in ops:
        if op == 0:
            img = img * rng.uniform(*brightness)
        elif op == 1:
            mean = _rgb_to_gray(img).mean()
            img = mean + (img - mean) * rng.uniform(*contrast)
        elif op == 2:
            gray = _rgb_to_gray(img)[..., None]
            img = gray + (img - gray) * rng.uniform(*saturation)
        else:
            img = _hue_shift(img, rng.uniform(*hue))
        img = np.clip(img, 0.0, 1.0)
    return img.astype(np.float32)


def _hue_shift(img: np.ndarray, delta: float) -> np.ndarray:
    """Shift hue by ``delta`` (fraction of a full turn) via HSV round-trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    span = maxc - minc
    s = np.where(maxc > 0, span / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(span, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = (h / 6.0) % 1.0
    h = (h + delta) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.empty_like(img)
    conds = [
        (v, t, p),
        (q, v, p),
        (p, v, t),
        (p, q, v),
        (t, p, v),
        (v, p, q),
    ]
    for k, (rr, gg, bb) in enumerate(conds):
        m = i == k
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out


def crop_and_scale_intrinsics(K: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Shift the principal point after a crop (reference
    camera_matrix_cropping, kitti.py:182-186)."""
    K = K.copy()
    K[0, 2] -= dx
    K[1, 2] -= dy
    return K


def scale_intrinsics(K: np.ndarray, s: float) -> np.ndarray:
    """(reference camera_matrix_scaling, kitti.py:188-191)"""
    K = s * K
    K[2, 2] = 1.0
    return K
