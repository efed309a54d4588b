"""nuScenes host-side dataset (a numpy copy of cofii2p_tpu/data/nuscenes.py).

Capability match for the reference's data/nuscenes.py:37-324: per-frame
``{train|test}/{img,pc,ext,int}/<name>.npy`` produced by the offline builder
(cofii2p_tpu_torch.data.build_nuscenes).  Differences from KITTI mirrored
from the reference: no normals (features become intensity + perturbed xyz,
handled on device), no voxel downsample, raw-index seeding
(nuscenes.py:179), and the ``valid_kpt`` capability is subsumed by the
device pipeline's per-slot ``kpt_valid`` mask.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.data.augment import random_se3
from cofii2p_tpu_torch.data.kitti import process_image
from cofii2p_tpu_torch.data.voxel import resample_fixed


class NuScenesDataset:
    has_normals = False

    def __init__(self, cfg: Config, mode: str):
        if mode not in ("train", "val"):
            raise ValueError(f"invalid mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.folder = "train" if mode == "train" else "test"
        self.root = cfg.data_path
        self.files = sorted(os.listdir(os.path.join(self.root, self.folder, "img")))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        cfg = self.cfg
        rng = np.random.RandomState(index)  # reference seeds with the raw index
        name = self.files[index]
        base = os.path.join(self.root, self.folder)
        img = np.load(os.path.join(base, "img", name))
        K = np.load(os.path.join(base, "int", name)).astype(np.float32)
        pc_raw = np.load(os.path.join(base, "pc", name))  # (4, N): xyz+intensity
        pc = pc_raw[0:3].T.astype(np.float32)
        intensity = pc_raw[3:4].T.astype(np.float32)

        pc, intensity = resample_fixed(pc, intensity, cfg.num_pc, rng)
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
        return {
            "img": img,
            "pc": pc,
            "attrs": intensity,
            "P": P,
            "K": K,
            "index": index,
        }
