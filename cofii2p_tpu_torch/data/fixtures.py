"""On-disk KITTI and nuScenes trees in the loaders' layout, made from a seed.

No frame of either dataset ships with the repo, so chip_smoke.py's
``kitti`` and ``nuscenes`` phases and the loader tests write trees that
data/kitti.py and data/nuscenes.py (and the JAX package's loaders) read as
they read the real ones:

- KITTI (CorrI2P layout): ``calib/00..10/calib.txt`` with sequence 00's
  calibration, ``sequences/00..10/{img_P2,img_P3,K_P2,K_P3,
  pc_npy_with_normal}/<frame>.npy``; images (H, W, 3) uint8 (376 x 1241 by
  default, KITTI's size), clouds (7, N) float32 in the velodyne frame
  (x forward, y left, z up): a ground plane, two facades along the road
  and boxes ahead, with intensity in [0, 1) and unit normals.
- nuScenes (the builder's output): ``{train,test}/{img,pc,ext,int}/
  <frame>.npy``; images (320, 640, 3) uint8 (the builder's 0.4 scale of
  800 x 1600 after its 100-row crop), clouds (4, N) float32 in the camera
  frame (x right, y down, z forward): xyz + intensity, the intrinsics
  after the builder's crop and scale.
"""

from __future__ import annotations

import os

import numpy as np

KITTI_IMAGE_HW = (376, 1241)
NUSCENES_IMAGE_HW = (320, 640)
# KITTI Odometry sequence 00's calibration (P0..P3 3x4, Tr velodyne -> cam0)
_KITTI_CALIB = {
    "P0": "7.188560e+02 0.000000e+00 6.071928e+02 0.000000e+00 0.000000e+00 7.188560e+02 1.852157e+02 "
          "0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00",
    "P1": "7.188560e+02 0.000000e+00 6.071928e+02 -3.861448e+02 0.000000e+00 7.188560e+02 1.852157e+02 "
          "0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00",
    "P2": "7.188560e+02 0.000000e+00 6.071928e+02 4.538225e+01 0.000000e+00 7.188560e+02 1.852157e+02 "
          "-1.130887e-01 0.000000e+00 0.000000e+00 1.000000e+00 3.779761e-03",
    "P3": "7.188560e+02 0.000000e+00 6.071928e+02 -3.372877e+02 0.000000e+00 7.188560e+02 1.852157e+02 "
          "2.369057e+00 0.000000e+00 0.000000e+00 1.000000e+00 4.915215e-03",
    "Tr": "4.276802385584e-04 -9.999672484946e-01 -8.084491683471e-03 -1.198459927713e-02 "
          "-7.210626507497e-03 8.081198471645e-03 -9.999413164504e-01 -5.403984729748e-02 "
          "9.999738645903e-01 4.859485810390e-04 -7.206933692422e-03 -2.921968648686e-01",
}
_KITTI_K = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]], np.float32)
# nuScenes CAM_FRONT intrinsics after the builder's 100-row crop and 0.4 scale
_NUSCENES_K = np.array([[1266.417 * 0.4, 0.0, 816.267 * 0.4], [0.0, 1266.417 * 0.4, (491.507 - 100) * 0.4],
                        [0.0, 0.0, 1.0]], np.float32)


def _street(n: int, rng: np.random.RandomState):
    """(n, 3) points and (n, 3) unit normals of a street scene in a
    forward-left-up frame, the sensor at the origin 1.73 m above the
    ground: 55% ground all around, 30% two facades 8-10 m to the sides,
    15% on the rear, side and roof faces of twelve car-sized boxes ahead."""
    n_ground, n_wall = int(n * 0.55), int(n * 0.30)
    n_box = n - n_ground - n_wall
    ground = np.stack([rng.uniform(-40, 70, n_ground), rng.uniform(-40, 40, n_ground),
                       rng.normal(-1.73, 0.02, n_ground)], -1)
    g_n = np.tile([0.0, 0.0, 1.0], (n_ground, 1))
    side = np.where(rng.rand(n_wall) < 0.5, 1.0, -1.0)
    wall = np.stack([rng.uniform(-30, 70, n_wall), side * rng.uniform(8, 10, n_wall), rng.uniform(-1.73, 6, n_wall)],
                    -1)
    w_n = np.stack([np.zeros(n_wall), -side, np.zeros(n_wall)], -1)
    centers = np.stack([rng.uniform(5, 50, 12), rng.uniform(-6, 6, 12)], -1)[rng.randint(0, 12, n_box)]
    face = rng.randint(0, 3, n_box)  # 0: rear, 1: side, 2: roof
    u, v = rng.rand(n_box), rng.rand(n_box)
    box = np.stack([centers[:, 0] + np.where(face == 0, -2.0, 4.0 * u - 2.0),
                    centers[:, 1] + np.where(face == 1, -0.9, 1.8 * v - 0.9),
                    -1.73 + np.where(face == 2, 1.5, 1.5 * v)], -1)
    b_n = np.zeros((n_box, 3))
    b_n[face == 0, 0] = -1.0
    b_n[face == 1, 1] = -1.0
    b_n[face == 2, 2] = 1.0
    pts = np.concatenate([ground, wall, box])
    normals = np.concatenate([g_n, w_n, b_n]) + rng.normal(0, 0.05, (n, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    perm = rng.permutation(n)
    return pts[perm], normals[perm]


def write_kitti_tree(root: str, seed: int, frames: dict, points: int = 120000, image_hw: dict | None = None) -> str:
    """A KITTI tree under ``root``: ``frames[seq]`` frames in each listed
    sequence (the others, up to 10, empty), each frame's P2 and P3 images
    of ``image_hw.get(seq, KITTI_IMAGE_HW)``, one (7, points) cloud.
    Returns ``root``."""
    rng = np.random.RandomState(seed)
    image_hw = image_hw or {}
    for seq in range(11):
        calib_dir = os.path.join(root, "calib", "%02d" % seq)
        os.makedirs(calib_dir, exist_ok=True)
        with open(os.path.join(calib_dir, "calib.txt"), "w") as f:
            f.writelines(f"{key}: {line}\n" for key, line in _KITTI_CALIB.items())
        seq_dir = os.path.join(root, "sequences", "%02d" % seq)
        for sub in ("img_P2", "img_P3", "K_P2", "K_P3", "pc_npy_with_normal"):
            os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
        h, w = image_hw.get(seq, KITTI_IMAGE_HW)
        for i in range(frames.get(seq, 0)):
            name = "%06d.npy" % i
            for cam in ("P2", "P3"):
                np.save(os.path.join(seq_dir, f"img_{cam}", name), rng.randint(0, 256, (h, w, 3), np.uint8))
                np.save(os.path.join(seq_dir, f"K_{cam}", name), _KITTI_K)
            pts, normals = _street(points, rng)
            cloud = np.concatenate([pts, rng.rand(points, 1), normals], -1).T.astype(np.float32)
            np.save(os.path.join(seq_dir, "pc_npy_with_normal", name), cloud)
    return root


def write_nuscenes_tree(root: str, seed: int, frames: dict, points: int = 50000,
                        image_hw: tuple = NUSCENES_IMAGE_HW) -> str:
    """A nuScenes tree under ``root``: ``frames[folder]`` frames in each of
    ``train`` and ``test``, each an (H, W, 3) uint8 image, a (4, points)
    camera-frame cloud, its extrinsic and intrinsics.  Returns ``root``."""
    rng = np.random.RandomState(seed)
    # forward-left-up -> camera (x right, y down, z forward)
    to_cam = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    for folder, count in frames.items():
        dirs = {k: os.path.join(root, folder, k) for k in ("img", "pc", "ext", "int")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for i in range(count):
            name = "%06d.npy" % i
            pts, _ = _street(points, rng)
            cam = pts @ to_cam.T
            cloud = np.concatenate([cam, rng.rand(points, 1)], -1).T.astype(np.float32)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = to_cam
            np.save(os.path.join(dirs["img"], name), rng.randint(0, 256, (*image_hw, 3), np.uint8))
            np.save(os.path.join(dirs["pc"], name), cloud)
            np.save(os.path.join(dirs["ext"], name), ext)
            np.save(os.path.join(dirs["int"], name), _NUSCENES_K)
    return root
