"""The port's host data path against the JAX package's, bit for bit.

Fixture trees in the real on-disk layouts (cofii2p_tpu_torch/data/
fixtures.py) at KITTI's image sizes, 376 x 1241 and 375 x 1242, so that the
odd widths' rounding runs; the same index must give the same frame dict
on both sides, every key ``np.array_equal``, in train and val mode.  The
JAX loader voxelises through its native host ops; with its NumPy fallback
the voxel order (and so every resampled cloud) would differ, so the
library must load here.  The port's resize is held against OpenCV itself,
its colour jitter against the JAX package's.
"""

import cv2
import numpy as np
import pytest

import cofii2p_tpu.config as jconfig
import cofii2p_tpu.data.augment as jaug
from cofii2p_tpu import native as jnative
from cofii2p_tpu.data.kitti import KittiDataset as JKitti
from cofii2p_tpu.data.nuscenes import NuScenesDataset as JNuScenes
import cofii2p_tpu_torch.config as tconfig
from cofii2p_tpu_torch import train
from cofii2p_tpu_torch.data import augment
from cofii2p_tpu_torch.data.fixtures import write_kitti_tree, write_nuscenes_tree
from cofii2p_tpu_torch.data.kitti import KittiDataset, resize_linear
from cofii2p_tpu_torch.data.nuscenes import NuScenesDataset

KEYS = {"img", "pc", "attrs", "P", "K", "index"}
# a 6000-point cloud keeps ~6000 voxels: num_pc 2048 draws a subset,
# 8192 repeats the cloud and fills the rest (reference kitti.py:168-180)
NUM_PC = (2048, 8192)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    # sequences 01 and 10 at 375 x 1242, the rest at 376 x 1241
    return write_kitti_tree(root, 3, {0: 2, 1: 1, 9: 2, 10: 1}, points=6000,
                            image_hw={1: (375, 1242), 10: (375, 1242)})


@pytest.fixture(scope="module")
def nuscenes_roots(tmp_path_factory):
    """The builder's 320 x 640 frames, and a tree of odd-sized ones."""
    root = str(tmp_path_factory.mktemp("nuscenes"))
    return {"builder": write_nuscenes_tree(root + "/builder", 4, {"train": 3, "test": 2}, points=3000),
            "odd": write_nuscenes_tree(root + "/odd", 5, {"train": 1, "test": 1}, points=1500, image_hw=(141, 333))}


def _assert_frames_equal(got, want, mode):
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert set(a) == set(b) == KEYS
        for k in KEYS:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (mode, i, k)
            assert np.array_equal(a[k], b[k]), (mode, i, k)


def test_jax_native_host_ops_load():
    """The JAX side's voxel order is its native one only if the library
    loads; a NumPy fallback would make the comparisons below meaningless."""
    assert jnative.available()


@pytest.mark.parametrize("num_pc", NUM_PC)
@pytest.mark.parametrize("mode", ["train", "val"])
def test_kitti_frames_equal_jax(kitti_root, mode, num_pc):
    assert jnative.available()
    cfg = dict(data_path=kitti_root, img_H=160, img_W=512, num_pc=num_pc)
    got = KittiDataset(tconfig.TinyConfig(**cfg), mode)
    assert len(got) == 6  # 3 frames x 2 cameras
    _assert_frames_equal(got, JKitti(jconfig.TinyConfig(**cfg), mode), mode)
    assert got[0]["pc"].shape == (num_pc, 3) and got[0]["attrs"].shape == (num_pc, 4)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("tree", ["builder", "odd"])
def test_nuscenes_frames_equal_jax(nuscenes_roots, mode, tree):
    """NuScenesConfig's 160 x 320 crop of the builder's frames, TinyConfig's
    32 x 64 of the odd ones."""
    name = "NuScenesConfig" if tree == "builder" else "TinyConfig"
    cfg = dict(data_path=nuscenes_roots[tree], num_pc=2048)
    got = NuScenesDataset(getattr(tconfig, name)(**cfg), mode)
    assert got.has_normals is JNuScenes.has_normals is False
    _assert_frames_equal(got, JNuScenes(getattr(jconfig, name)(**cfg), mode), mode)
    assert got[0]["attrs"].shape == (2048, 1)


RESIZES = [((376, 1241), 0.5), ((375, 1242), 0.5), ((370, 1226), 0.5), ((400, 1300), 0.5), ((800, 1600), 0.4),
           ((800, 1600), 0.5), ((350, 800), 0.4), ((900, 1600), 0.4)]


@pytest.mark.parametrize("hw,scale", RESIZES, ids=lambda v: str(v))
def test_resize_linear_equals_opencv(hw, scale):
    """uint8 (colour and grey): OpenCV's fixed point, bit for bit;
    float32: within 1e-4."""
    rng = np.random.RandomState(hw[1])
    dsize = (int(round(hw[1] * scale)), int(round(hw[0] * scale)))
    img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    got = resize_linear(img, dsize)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} values differ"
    gray = np.ascontiguousarray(img[..., 1])
    assert np.array_equal(resize_linear(gray, dsize), cv2.resize(gray, dsize, interpolation=cv2.INTER_LINEAR))
    fimg = rng.rand(*hw, 3).astype(np.float32)
    fgot = resize_linear(fimg, dsize)
    assert fgot.dtype == np.float32
    np.testing.assert_allclose(fgot, cv2.resize(fimg, dsize, interpolation=cv2.INTER_LINEAR), rtol=0, atol=1e-4)


def test_resize_linear_refuses_other_dtypes():
    with pytest.raises(TypeError):
        resize_linear(np.zeros((8, 8, 3), np.float64), (4, 4))


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_and_hue_shift_equal_jax(seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(40, 64, 3).astype(np.float32)
    img[:4] = img[:4, :, :1]  # grey rows: span 0, the hue's degenerate branch
    got = augment.color_jitter(img, np.random.RandomState(100 + seed))
    want = jaug.color_jitter(img, np.random.RandomState(100 + seed))
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    for delta in (-0.1, 0.03, 0.1):
        assert np.array_equal(augment._hue_shift(img, delta), jaug._hue_shift(img, delta))
    assert np.array_equal(augment._rgb_to_gray(img), jaug._rgb_to_gray(img))
    K = rng.rand(3, 3).astype(np.float32)
    assert np.array_equal(augment.scale_intrinsics(K, 0.4), jaug.scale_intrinsics(K, 0.4))
    assert np.array_equal(augment.crop_and_scale_intrinsics(K, 3, 7), jaug.crop_and_scale_intrinsics(K, 3, 7))


def test_build_dataset_dispatches_like_jax(kitti_root, nuscenes_roots):
    cfg = tconfig.TinyConfig(data_path=kitti_root)
    assert isinstance(train.build_dataset("kitti", cfg, "train", False), KittiDataset)
    ds = train.build_dataset("nuscenes", tconfig.TinyConfig(data_path=nuscenes_roots["builder"]), "val", False)
    assert isinstance(ds, NuScenesDataset) and len(ds) == 2
    with pytest.raises(ValueError, match="tiny"):
        train.build_dataset("tiny", cfg, "train", False)


# TinyConfig's sizes as overrides of the kitti and nuscenes configurations
TINY = ["img_H=32", "img_W=64", "num_pc=512", "num_kpt=8", "neighbor_num=16", "ransac_hypotheses=32",
        "num_workers=2"]


def test_train_cli_reads_a_kitti_tree(kitti_root, tmp_path):
    """``train kitti data_path=...`` without --synthetic: one step on the
    loader's frames, a checkpoint written; on the card unless told
    otherwise."""
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint

    argv = ["kitti", f"data_path={kitti_root}", f"root_path={tmp_path}", "--steps", "1", "--batch_size", "2", *TINY]
    save_dir = train.main(argv + ["--device", "cpu"])
    assert latest_checkpoint(save_dir).endswith("step_00000001.pt")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(argv)


def test_eval_all_cli_reads_a_nuscenes_tree(nuscenes_roots, tmp_path, monkeypatch):
    """``eval_all none nuscenes data_path=...``: every val frame of the tree
    evaluated, dumped, and the error arrays written."""
    from cofii2p_tpu_torch.evaluation import eval_all

    monkeypatch.chdir(tmp_path)
    r_errs, t_errs = eval_all.main(["none", "nuscenes", f"data_path={nuscenes_roots['builder']}", "--batch_size", "2",
                                    "--eval_path", str(tmp_path / "dumps"), "--device", "cpu", *TINY])
    dumps = sorted((tmp_path / "dumps" / "nuscenes").glob("*/*.npy"))
    assert len(dumps) == 2
    assert set(np.load(dumps[0], allow_pickle=True).item()) == {
        "GT_P", "pred_P", "K", "fine_xy", "corr_mask", "object_points", "superpoints_score"}
    assert (tmp_path / "nuscenes_t_error.npy").exists() and (tmp_path / "nuscenes_r_error.npy").exists()
    assert len(r_errs) == len(t_errs) <= 2 and np.isfinite(r_errs).all()
