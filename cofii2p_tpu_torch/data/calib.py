"""KITTI Odometry calibration reader (a copy of cofii2p_tpu/data/calib.py).

Same capability as the reference KittiCalibHelper
(reference data/kitti.py:22-66): parses ``calib/<seq>/calib.txt`` into
the camera-to-camera translations (P2/P3 decomposed against their shared K)
and the velodyne->cam0 extrinsic Tr.
"""

from __future__ import annotations

import os

import numpy as np


class KittiCalib:
    def __init__(self, root_path: str):
        self.root_path = root_path
        self.matrices: dict[int, dict[str, np.ndarray]] = {}
        calib_root = os.path.join(root_path, "calib")
        for seq_name in sorted(os.listdir(calib_root)):
            seq = int(seq_name)
            self.matrices[seq] = self._parse(
                os.path.join(calib_root, seq_name, "calib.txt")
            )

    @staticmethod
    def _parse(path: str) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                key = line[:2]
                mat = np.fromstring(line[4:], sep=" ", dtype=np.float32).reshape(3, 4)
                if key == "Tr":
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :] = mat
                    out["Tr"] = T
                else:
                    K = mat[:3, :3]
                    out[key + "_K"] = K
                    # P = K [I | t_cam]; recover the camera-frame translation
                    tz = mat[2, 3]
                    tx = (mat[0, 3] - K[0, 2] * tz) / K[0, 0]
                    ty = (mat[1, 3] - K[1, 2] * tz) / K[1, 1]
                    T = np.eye(4, dtype=np.float32)
                    T[:3, 3] = (tx, ty, tz)
                    out[key] = T
        return out

    def get(self, seq: int, key: str) -> np.ndarray:
        return self.matrices[seq][key]
