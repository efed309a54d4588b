"""The port's native host ops (cofii2p_tpu_torch/native) against the JAX
package's: built from the port's own copy of host_ops.cc with the same
flags, they must give the same voxels in the same order (the order the
KITTI loader's resample draws over), the same kNN and the same FPS; and a
library that does not build or load raises instead of falling back."""

import numpy as np
import pytest

from cofii2p_tpu import native as jnative
from cofii2p_tpu_torch import native


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    assert jnative.available()  # no fallback on the side compared against


@pytest.mark.parametrize("n,voxel,attrs", [(5000, 0.5, 2), (120000, 0.1, 4), (3000, 0.2, 0), (1, 0.1, 1)])
def test_voxel_downsample_equals_jax_in_value_and_order(n, voxel, attrs):
    rng = np.random.RandomState(n)
    pts = (rng.randn(n, 3) * 10).astype(np.float32)
    pts[: n // 4] = pts[n // 4 : 2 * (n // 4)]  # duplicated points share voxels
    at = rng.rand(n, attrs).astype(np.float32) if attrs else None
    p1, a1 = native.voxel_downsample(pts, at, voxel)
    p2, a2 = jnative.voxel_downsample(pts, at, voxel)
    assert p1.dtype == np.float32 and np.array_equal(p1, p2)
    assert (a1 is None and a2 is None) or np.array_equal(a1, a2)
    assert len(p1) < n or n == 1


def test_knn_and_fps_equal_jax():
    rng = np.random.RandomState(1)
    q = (rng.randn(300, 3) * 5).astype(np.float32)
    d = (rng.randn(2000, 3) * 5).astype(np.float32)
    for k, cell in ((1, 0.0), (8, 0.0), (16, 1.5)):
        assert np.array_equal(native.knn(q, d, k, cell), jnative.knn(q, d, k, cell))
    small = d[:3]
    assert np.array_equal(native.knn(q, small, 5), jnative.knn(q, small, 5))  # padded with len(db)
    assert (native.knn(q, small, 5)[:, 3:] == 3).all()
    for start in (0, 17):
        assert np.array_equal(native.farthest_point_sampling(d, 32, start),
                              jnative.farthest_point_sampling(d, 32, start))


def test_fps_approximate_equals_jax():
    from cofii2p_tpu.data.kitti_utils import fps_approximate as j_fps
    from cofii2p_tpu_torch.data.kitti_utils import fps_approximate

    pts = (np.random.RandomState(2).rand(4000, 3) * 20).astype(np.float32)
    for voxel, num in ((1.0, 64), (5.0, 200)):
        assert np.array_equal(fps_approximate(pts, voxel, num), j_fps(pts, voxel, num))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cc"
    bad.write_text('extern "C" int voxel_downsample( { }\n')
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        native.voxel_downsample(np.zeros((4, 3), np.float32), None, 0.1)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.knn(np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32), 2)


def test_inputs_are_checked_before_the_call():
    with pytest.raises(ValueError):
        native.voxel_downsample(np.zeros((4, 2), np.float32), None, 0.1)
    with pytest.raises(ValueError):
        native.voxel_downsample(np.zeros((4, 3), np.float32), np.zeros((3, 1), np.float32), 0.1)
    with pytest.raises(ValueError):
        native.farthest_point_sampling(np.zeros((4, 3), np.float32), 2, start=4)
