"""KITTI Odometry host-side dataset (a numpy copy of
cofii2p_tpu/data/kitti.py, with OpenCV's bilinear resize written out in
numpy: the port does not depend on OpenCV).

The host does only: file IO, cam-frame transform, voxel downsample (the
native host ops, cofii2p_tpu_torch/native) + fixed resample, image
resize/crop/jitter, and intrinsics bookkeeping; the perturbation, pyramid
and GT correspondences run on the device
(cofii2p_tpu_torch/data/device_pipeline.py).  The same index gives the
same frame dict as the JAX package's loader, bit for bit.

Frame layout on disk is the CorrI2P/CoFiI2P recipe the reference consumes:
``sequences/<seq>/img_P2|img_P3/<frame>.npy``,
``sequences/<seq>/pc_npy_with_normal/<frame>.npy`` (7, N): xyz+intensity+
normals, ``sequences/<seq>/K_P2|K_P3/<frame>.npy`` and ``calib/<seq>/
calib.txt``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.data.augment import (
    color_jitter,
    crop_and_scale_intrinsics,
    random_se3,
    scale_intrinsics,
)
from cofii2p_tpu_torch.data.calib import KittiCalib
from cofii2p_tpu_torch.data.voxel import resample_fixed
from cofii2p_tpu_torch.native import voxel_downsample


class KittiDataset:
    """Yields host-side sample dicts: img, pc (camera frame, fixed size),
    attrs (intensity+normals), P (random perturbation), K (cropped half-res
    intrinsics)."""

    has_normals = True

    def __init__(self, cfg: Config, mode: str):
        if mode not in ("train", "val"):
            raise ValueError(f"invalid mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.root = cfg.data_path
        self.calib = KittiCalib(self.root)
        self.frames = self._list_frames(mode)

    def _list_frames(self, mode: str):
        seqs = list(range(9)) if mode == "train" else [9, 10]
        frames = []
        for seq in seqs:
            seq_dir = os.path.join(self.root, "sequences", "%02d" % seq)
            n = len(os.listdir(os.path.join(seq_dir, "img_P2")))
            for i in range(n):
                frames.append((seq, i, "P2"))
                frames.append((seq, i, "P3"))
        return frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        cfg = self.cfg
        # deterministic per-index stream (reference kitti.py:261-264)
        (seed,) = np.random.SeedSequence([index]).generate_state(1)
        rng = np.random.RandomState(seed)

        seq, i, cam = self.frames[index]
        seq_dir = os.path.join(self.root, "sequences", "%02d" % seq)
        img = np.load(os.path.join(seq_dir, f"img_{cam}", "%06d.npy" % i))
        data = np.load(
            os.path.join(seq_dir, "pc_npy_with_normal", "%06d.npy" % i)
        )  # (7, N)
        K = np.load(os.path.join(seq_dir, f"K_{cam}", "%06d.npy" % i)).astype(
            np.float32
        )
        pc = data[0:3].T.astype(np.float32)
        intensity = data[3:4].T.astype(np.float32)
        sn = data[4:7].T.astype(np.float32)

        # velodyne -> chosen camera frame (reference kitti.py:274-278)
        P_Tr = self.calib.get(seq, cam) @ self.calib.get(seq, "Tr")
        pc = pc @ P_Tr[:3, :3].T + P_Tr[:3, 3]
        sn = sn @ P_Tr[:3, :3].T

        pc, attrs = voxel_downsample(pc, np.concatenate([intensity, sn], -1), 0.1)
        pc, attrs = resample_fixed(pc, attrs, cfg.num_pc, rng)

        P = random_se3(
            rng,
            dict(
                tx=cfg.P_tx_amplitude,
                ty=cfg.P_ty_amplitude,
                tz=cfg.P_tz_amplitude,
                rx=cfg.P_Rx_amplitude,
                ry=cfg.P_Ry_amplitude,
                rz=cfg.P_Rz_amplitude,
            ),
        )

        img, K = process_image(img, K, cfg, self.mode, rng)
        return {"img": img, "pc": pc, "attrs": attrs, "P": P, "K": K, "index": index}


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR source taps along one axis: the left tap s0,
    the right tap s1 and the right tap's weight f (float32), with both
    taps clamped at the edges."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    f = f - s0.astype(np.float32)
    left = s0 < 0
    s0[left], f[left] = 0, 0.0
    s1 = np.minimum(s0 + 1, n_in - 1)
    right = s0 + 1 >= n_in
    s0[right], s1[right], f[right] = n_in - 1, n_in - 1, 0.0
    return s0, s1, f


def resize_linear(img: np.ndarray, dsize: tuple) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)`` for an
    (H, W) or (H, W, C) image, ``dsize = (width, height)``.

    ``uint8`` takes OpenCV's fixed point: 11-bit weights
    (``a1 = rint(f * 2048)``, ``a0 = 2048 - a1``), the horizontal pass in
    int32, the vertical one as OpenCV's SIMD path rounds it
    (``((b0 * (R0 >> 4)) >> 16) + ((b1 * (R1 >> 4)) >> 16) + 2) >> 2``,
    clamped to [0, 255]), bit-equal to OpenCV on the downscales the
    loaders make (x0.5 of KITTI's frames, x0.4 of nuScenes').  ``float32``
    takes the same taps with unquantised weights.
    """
    w, h = dsize
    x0, x1, fx = _linear_taps(img.shape[1], w)
    y0, y1, fy = _linear_taps(img.shape[0], h)
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    if img.dtype == np.uint8:
        a1 = np.rint(fx * 2048).astype(np.int32)
        b1 = np.rint(fy * 2048).astype(np.int32)
        a0, b0 = 2048 - a1, 2048 - b1
        src = img.astype(np.int32)
        rows = (src[:, x0] * a0.reshape(col) + src[:, x1] * a1.reshape(col)) >> 4
        out = ((b0.reshape(row) * rows[y0]) >> 16) + ((b1.reshape(row) * rows[y1]) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    if img.dtype != np.float32:
        raise TypeError(f"resize_linear takes uint8 or float32 images, not {img.dtype}")
    rows = img[:, x0] * (1 - fx).reshape(col) + img[:, x1] * fx.reshape(col)
    return rows[y0] * (1 - fy).reshape(row) + rows[y1] * fy.reshape(row)


def process_image(img: np.ndarray, K: np.ndarray, cfg: Config, mode: str, rng):
    """Resize x0.5, crop to (img_H, img_W), adjust K, jitter when training
    (reference kitti.py:306-330)."""
    img = resize_linear(img, (int(round(img.shape[1] * 0.5)), int(round(img.shape[0] * 0.5))))
    K = scale_intrinsics(K, 0.5)
    if mode == "train":
        dx = rng.randint(0, img.shape[1] - cfg.img_W + 1)
        dy = rng.randint(0, img.shape[0] - cfg.img_H + 1)
    else:
        dx = (img.shape[1] - cfg.img_W) // 2
        dy = (img.shape[0] - cfg.img_H) // 2
    img = img[dy : dy + cfg.img_H, dx : dx + cfg.img_W]
    K = crop_and_scale_intrinsics(K, dx, dy)
    img = img.astype(np.float32) / 255.0
    if mode == "train":
        img = color_jitter(img, rng)
    return img, K.astype(np.float32)
