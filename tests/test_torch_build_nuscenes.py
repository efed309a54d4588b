"""The port's offline nuScenes builder against the JAX package's, on the
fake devkit and world of tests/test_build_nuscenes.py: the same frames
selected, the same cameras paired, and the same ``img/pc/ext/int`` files
written, bit for bit (the port resizes with its numpy copy of OpenCV's
bilinear, the JAX builder with OpenCV)."""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests.test_build_nuscenes import WorldBuilder, _quat_yaw90, _save_cloud  # installs the fake devkit

from cofii2p_tpu.config import NuScenesConfig as JNuScenesConfig  # noqa: E402
from cofii2p_tpu.data import build_nuscenes as jbn  # noqa: E402
from cofii2p_tpu_torch.config import NuScenesConfig  # noqa: E402
from cofii2p_tpu_torch.data import build_nuscenes as bn  # noqa: E402


def _world(tmp_path, image_hw, in_view=True):
    """A day scene: a 60000-point center sweep in front of the camera, a
    second sweep from an ego pose 2 m ahead and turned 90 degrees, a
    night scene, and a camera chain marching 2 m a frame."""
    from PIL import Image

    w = WorldBuilder(tmp_path)
    rng = np.random.RandomState(0)
    n = 60000
    z = rng.uniform(5.0, 50.0, n)
    pts = np.stack([rng.uniform(-0.85, 0.85, n) * z, rng.uniform(-0.15, 0.35, n) * z, z], -1).astype(np.float32)
    if not in_view:
        pts[:, 2] *= -1.0
    f0 = _save_cloud(w.root, "c0.npy", pts, rng.rand(1, n).astype(np.float32))
    f1 = _save_cloud(w.root, "c1.npy", pts[:3000] + 1.0)
    s = image_hw[1] / 1600  # nuScenes CAM_FRONT's intrinsics, scaled to the image
    K = [[1266.4 * s, 0.0, 816.3 * s], [0.0, 1266.4 * s, 491.5 * s], [0.0, 0.0, 1.0]]
    w.cam_calib("cal_cam", K)
    Image.fromarray(rng.randint(0, 256, (*image_hw, 3)).astype(np.uint8)).save(os.path.join(w.root, "img.png"))
    lt = w.chain("L", 4, "smp", [[0, 0, 0], [2.0, 0, 0], [4.0, 0, 0], [6.0, 0, 0]], filenames=[f0, f1, f1, f1],
                 rotations=[None, _quat_yaw90(), None, None])
    ct = w.chain("C", 7, "smp", [[2.0 * i, 0, 0] for i in range(7)], filenames=["img.png"] * 7, calib="cal_cam")
    w.sample("smp", lt[0], ct[0])
    w.scene("s", "Sunny afternoon", "smp")
    ln = w.chain("Ln", 2, "smp_n", [[0, 0, 0]] * 2)
    cn = w.chain("Cn", 1, "smp_n", [[0, 0, 0]])
    w.sample("smp_n", ln[0], cn[0])
    w.scene("scene_night", "Night drive", "smp_n")
    return w


def test_selection_and_pairing_equal_jax(tmp_path):
    nusc = _world(tmp_path, (90, 160)).nusc()
    for skip in (1, 2, 3):
        assert bn.daytime_lidar_tokens(nusc, skip) == jbn.daytime_lidar_tokens(nusc, skip)
    for dist in (3.0, 10.0):
        assert bn.nearby_front_cameras(nusc, "L0", dist) == jbn.nearby_front_cameras(nusc, "L0", dist)
    for num, skip in ((1, 1), (3, 1), (2, 2)):
        got, want = bn.accumulate_sweeps(nusc, "L0", num, skip), jbn.accumulate_sweeps(nusc, "L0", num, skip)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert bn.NIGHT_SCENE_TOKENS == jbn.NIGHT_SCENE_TOKENS


@pytest.mark.parametrize("image_hw,in_view", [((900, 1600), True), ((450, 800), True), ((450, 800), False)])
def test_build_frame_writes_the_jax_files(tmp_path, image_hw, in_view):
    """nuScenes' 900 x 1600 frames (cropped to 800 rows, x0.4 to 320 x
    640) and the fake world's 450 x 800 ones, two sweeps accumulated."""
    nusc = _world(tmp_path, image_hw, in_view).nusc()
    outs = {}
    for name, mod, cfg in (("port", bn, NuScenesConfig), ("jax", jbn, JNuScenesConfig)):
        dirs = {k: str(tmp_path / name / k) for k in ("img", "pc", "ext", "int")}
        for d in dirs.values():
            os.makedirs(d)
        ok = mod.build_frame(nusc, cfg(accumulation_frame_num=1, accumulation_frame_skip=1), "L0", ["C0", "C1"], 3,
                             dirs)
        outs[name] = ok, dirs
    assert outs["port"][0] == outs["jax"][0] == in_view
    for k in ("img", "pc", "ext", "int"):
        names = sorted(os.listdir(outs["port"][1][k]))
        assert names == sorted(os.listdir(outs["jax"][1][k])) == (["000003.npy"] if in_view else [])
        for f in names:
            a, b = (np.load(os.path.join(outs[s][1][k], f)) for s in ("port", "jax"))
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    if in_view:
        img = np.load(os.path.join(outs["port"][1]["img"], "000003.npy"))
        assert img.shape[:2] == (round((image_hw[0] - 100) * 0.4), round(image_hw[1] * 0.4))
