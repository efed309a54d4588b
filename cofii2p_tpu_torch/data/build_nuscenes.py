"""Offline nuScenes dataset builder (a copy of
cofii2p_tpu/data/build_nuscenes.py; its image resize is the loaders'
OpenCV-exact ``resize_linear``, so the port needs no OpenCV).

Capability match for the reference's data/build_nuscenes/{build_datainfo.py,
build_dataset.py}: select daytime scenes (skipping the known night-scene
tokens), take every ``frame_skip``-th LiDAR sweep, pair it with nearby
CAM_FRONT frames whose ego displacement is under ``max_translation`` m,
accumulate +-accumulation_frame_num sweeps into one cloud (ego-motion
compensated), voxel-downsample at 0.2 m, and save per-frame
``img/pc/ext/int`` .npy files for frames with > 6000 in-view points.

Requires the nuscenes-devkit (not bundled in this image); the import is
gated so the rest of the framework never depends on it.  Rotation math uses
scipy instead of pyquaternion; parallelism is a multiprocessing Pool over
frame shards (reference: 20 hand-sliced Processes, build_dataset.py:338-358).

Usage:
  python -m cofii2p_tpu_torch.data.build_nuscenes <nuscenes_root> <output_dir>
      [--mode trainval|test] [--frame_skip 2] [--max_translation 10]
"""

from __future__ import annotations

import argparse
import os
import multiprocessing

import numpy as np

from cofii2p_tpu_torch.config import NuScenesConfig
from cofii2p_tpu_torch.data.augment import crop_and_scale_intrinsics, scale_intrinsics
from cofii2p_tpu_torch.data.kitti import resize_linear
from cofii2p_tpu_torch.data.voxel import voxel_downsample

NIGHT_SCENE_TOKENS = frozenset(
    # test-split scenes recorded at night whose descriptions lack the word
    # (reference build_datainfo.py:10-28)
    [
        "e59a4d0cc6a84ed59f78fb21a45cdcb4", "7209495d06f24712a063ac6c4a9b403b",
        "3d776ea805f240bb925bd9b50b258416", "48f81c548d0148fc8010a73d70b2ef9c",
        "2ab683f384234dce89800049dec19a30", "7edca4c44eac4f52a3105e1794e56b7e",
        "81c939ce8c0d4cc7b159cb5ed4c4e712", "24e6e64ecf794be4a51f7454c8b6d0b2",
        "828ed34a5e0c456fbf0751cabbab3341", "edfd6cfd1805477fbeadbd29f39ed599",
        "7692a3e112b44b408d191e45954a813c", "58d27a9f83294d99a4ff451dcad5f4d2",
        "a1573aef0bf74324b373dd8a22b4dd68", "ba06095d4e2e425b8e398668abc301d8",
        "7c315a1db2ac49439d281605f3cca6be", "732d7a84353f4ada803a9a115728496c",
        "1630a1d9cf8a46b3843662a23126e3f6", "f437809584344859882bdff7f8784c43",
    ]
)


def _require_devkit():
    try:
        from nuscenes.nuscenes import NuScenes  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the nuScenes builder needs the nuscenes-devkit package; install "
            "it in an environment with network access and re-run"
        ) from e


def _pose_matrix(rotation_wxyz, translation) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    w, x, y, z = rotation_wxyz
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = Rotation.from_quat([x, y, z, w]).as_matrix().astype(np.float32)
    P[:3, 3] = np.asarray(translation, np.float32)
    return P


def _ego_pose(nusc, sample_data) -> np.ndarray:
    pose = nusc.get("ego_pose", sample_data["ego_pose_token"])
    return _pose_matrix(pose["rotation"], pose["translation"])


def _calib(nusc, sample_data) -> np.ndarray:
    calib = nusc.get("calibrated_sensor", sample_data["calibrated_sensor_token"])
    return _pose_matrix(calib["rotation"], calib["translation"])


def daytime_lidar_tokens(nusc, frame_skip: int) -> list[str]:
    """Every frame_skip-th LIDAR_TOP sweep of every daytime scene
    (reference build_datainfo.py:31-59)."""
    tokens = []
    for scene in nusc.scene:
        desc = scene["description"]
        if "night" in desc or "Night" in desc or scene["token"] in NIGHT_SCENE_TOKENS:
            continue
        sample = nusc.get("sample", scene["first_sample_token"])
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        tokens.append(sd["token"])
        count = 1
        while sd["next"]:
            sd = nusc.get("sample_data", sd["next"])
            count += 1
            if count % frame_skip == 0:
                tokens.append(sd["token"])
    return tokens


def nearby_front_cameras(nusc, lidar_token: str, max_translation: float) -> list[str]:
    """CAM_FRONT frames within max_translation m of the sweep's ego pose,
    walked in both directions from the keyframe camera
    (reference build_datainfo.py:81-135)."""
    lidar = nusc.get("sample_data", lidar_token)
    lidar_P_inv = np.linalg.inv(_ego_pose(nusc, lidar))
    sample = nusc.get("sample", lidar["sample_token"])
    first = nusc.get("sample_data", sample["data"]["CAM_FRONT"])
    out = [first["token"]]
    for direction in ("next", "prev"):
        cam = first
        while cam[direction]:
            cam = nusc.get("sample_data", cam[direction])
            t = (lidar_P_inv @ _ego_pose(nusc, cam))[:3, 3]
            if np.linalg.norm(t) < max_translation:
                out.append(cam["token"])
            else:
                break
    return out


def _load_sweep(nusc, token: str):
    """Load one sweep, dropping ego-car returns (reference
    build_dataset.py:109-121)."""
    from nuscenes.utils.data_classes import LidarPointCloud

    sd = nusc.get("sample_data", token)
    pc = LidarPointCloud.from_file(os.path.join(nusc.dataroot, sd["filename"]))
    pts = pc.points[:3]
    intensity = pc.points[3:4]
    on_car = (np.abs(pts[0]) < 0.8) & (np.abs(pts[1]) < 2.7)
    keep = ~on_car
    return pts[:, keep], intensity[:, keep], _ego_pose(nusc, sd)


def accumulate_sweeps(nusc, lidar_token: str, num: int, skip: int):
    """Merge the sweep with +-num neighbors (every skip-th), ego-motion
    compensated into the center sweep's lidar frame
    (reference build_dataset.py:124-185)."""
    lidar = nusc.get("sample_data", lidar_token)
    pts0, int0, P_oi = _load_sweep(nusc, lidar_token)
    P_io = np.linalg.inv(P_oi)
    P_vl = _calib(nusc, lidar)
    P_lv = np.linalg.inv(P_vl)

    pcs, intensities = [pts0], [int0]
    for direction in ("next", "prev"):
        sd = lidar
        counter, accumulated = 1, 0
        while accumulated < num and sd[direction]:
            if counter % skip != 0:
                counter += 1
                sd = nusc.get("sample_data", sd[direction])
                continue
            pts_j, int_j, P_oj = _load_sweep(nusc, sd[direction])
            P = P_lv @ (P_io @ P_oj) @ P_vl
            pcs.append(P[:3, :3] @ pts_j + P[:3, 3:])
            intensities.append(int_j)
            counter += 1
            accumulated += 1
            sd = nusc.get("sample_data", sd[direction])
    return np.concatenate(pcs, axis=1), np.concatenate(intensities, axis=1)


def build_frame(nusc, cfg, lidar_token, cam_tokens, idx, out_dirs) -> bool:
    """Build and save one frame; returns True if a valid camera was found
    (reference make_dataset, build_dataset.py:203-305)."""
    pc, intensity = accumulate_sweeps(
        nusc, lidar_token, cfg.accumulation_frame_num, cfg.accumulation_frame_skip
    )
    if pc.shape[1] < 45000:
        return False
    pts, attrs = voxel_downsample(pc.T.astype(np.float32), intensity.T, 0.2)
    if pts.shape[0] < 45000:
        return False
    pc, intensity = pts.T, attrs.T

    lidar = nusc.get("sample_data", lidar_token)
    P_lidar = _ego_pose(nusc, lidar) @ _calib(nusc, lidar)

    from PIL import Image

    for cam_token in cam_tokens:
        cam = nusc.get("sample_data", cam_token)
        img = np.asarray(Image.open(os.path.join(nusc.dataroot, cam["filename"])))
        K = np.asarray(
            nusc.get("calibrated_sensor", cam["calibrated_sensor_token"])[
                "camera_intrinsic"
            ],
            np.float32,
        )
        img = img[cfg.crop_original_top_rows :]
        K = crop_and_scale_intrinsics(K, 0, cfg.crop_original_top_rows)
        img = resize_linear(
            img,
            (
                int(round(img.shape[1] * cfg.img_scale)),
                int(round(img.shape[0] * cfg.img_scale)),
            ),
        )
        K = scale_intrinsics(K, cfg.img_scale)

        P_cam = _ego_pose(nusc, cam) @ _calib(nusc, cam)
        P_cam_pc = np.linalg.inv(P_cam) @ P_lidar  # lidar -> camera
        pc_cam = P_cam_pc[:3, :3] @ pc + P_cam_pc[:3, 3:]

        h, w = img.shape[:2]
        uvz = K @ pc_cam
        uv = uvz[:2] / np.maximum(uvz[2:], 1e-12)
        inside = np.sum(
            (uvz[2] > 0)
            & (uv[0] >= 0) & (uv[0] <= w - 1)
            & (uv[1] >= 0) & (uv[1] <= h - 1)
        )
        if inside > 6000:
            name = "%06d.npy" % idx
            np.save(
                os.path.join(out_dirs["pc"], name),
                np.concatenate([pc_cam, intensity], axis=0).astype(np.float32),
            )
            np.save(os.path.join(out_dirs["img"], name), img)
            np.save(os.path.join(out_dirs["ext"], name), P_cam_pc)
            np.save(os.path.join(out_dirs["int"], name), K)
            return True
    return False


def _worker(args):
    root, version, cfg, shard, out_dirs = args
    from nuscenes.nuscenes import NuScenes

    nusc = NuScenes(version=version, dataroot=root, verbose=False)
    built = 0
    for idx, lidar_token in shard:
        cams = nearby_front_cameras(nusc, lidar_token, 10.0)
        built += build_frame(nusc, cfg, lidar_token, cams, idx, out_dirs)
    return built


def main(argv=None):
    _require_devkit()
    from nuscenes.nuscenes import NuScenes

    parser = argparse.ArgumentParser()
    parser.add_argument("root")
    parser.add_argument("output")
    parser.add_argument("--mode", default="trainval", choices=["trainval", "test"])
    parser.add_argument("--frame_skip", type=int, default=2)
    parser.add_argument("--max_translation", type=float, default=10.0)
    parser.add_argument("--workers", type=int, default=20)
    args = parser.parse_args(argv)

    cfg = NuScenesConfig()
    root = os.path.join(args.root, args.mode)
    version = "v1.0-" + args.mode
    out_base = os.path.join(args.output, args.mode)
    out_dirs = {k: os.path.join(out_base, k) for k in ("img", "pc", "ext", "int")}
    for d in out_dirs.values():
        os.makedirs(d, exist_ok=True)

    nusc = NuScenes(version=version, dataroot=root, verbose=True)
    tokens = daytime_lidar_tokens(nusc, args.frame_skip)
    print(f"{len(tokens)} lidar frames selected")
    del nusc  # workers re-open; NuScenes handles don't pickle

    shards = [list() for _ in range(args.workers)]
    for i, tok in enumerate(tokens):
        shards[i % args.workers].append((i, tok))
    jobs = [(root, version, cfg, s, out_dirs) for s in shards if s]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        built = sum(pool.map(_worker, jobs))
    print(f"built {built}/{len(tokens)} frames into {out_base}")


if __name__ == "__main__":
    main()
