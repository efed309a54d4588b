"""The port's index-map ops against the JAX package's, on seeded numpy
inputs: the k-NN search and the pyramid's three maps (indices equal, ties
included), grid subsampling, radius search, farthest point sampling (JAX's
start index replayed; indices equal), k-NN interpolation, global average
pooling and the geometry helpers (rel 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.ops import geometry as jgeo
from cofii2p_tpu.ops.knn import knn as j_knn
from cofii2p_tpu.ops.knn import knn_with_distances as j_knn_with_distances
from cofii2p_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from cofii2p_tpu.ops.pyramid import build_pyramid_batched as j_build_pyramid_batched
from cofii2p_tpu.ops.sampling import farthest_point_sampling as j_fps
from cofii2p_tpu.ops.sampling import global_avgpool as j_global_avgpool
from cofii2p_tpu.ops.sampling import knn_interpolate as j_knn_interpolate
from cofii2p_tpu.ops.subsample import grid_subsample as j_grid_subsample
from cofii2p_tpu.ops.subsample import radius_search as j_radius_search
from cofii2p_tpu_torch.ops import geometry as tgeo
from cofii2p_tpu_torch.ops.knn import knn, knn_with_distances
from cofii2p_tpu_torch.ops.pyramid import build_pyramid, build_pyramid_batched
from cofii2p_tpu_torch.ops.sampling import farthest_point_sampling, global_avgpool, knn_interpolate
from cofii2p_tpu_torch.ops.subsample import grid_subsample, radius_search
from tests.torch_parity import lidar_cloud, rel_err

T = torch.as_tensor


def cloud_with_duplicates(n, seed, share=8):
    """A KITTI-like cloud in which one point in ``share`` repeats another,
    so that k-th distances tie."""
    rng = np.random.default_rng(seed)
    base = lidar_cloud(n - n // share, rng, extent=6.0)
    return np.concatenate([base, base[rng.integers(0, len(base), n // share)]])[rng.permutation(n)]


@pytest.mark.parametrize("k", [1, 16, 37])
def test_knn_matches_jax(k):
    """Indices equal, duplicates included: on equal distances the lower
    index first, also at the k-th boundary."""
    db = cloud_with_duplicates(700, 0)
    q = np.concatenate([db[:150], cloud_with_duplicates(150, 1)])
    want = np.asarray(j_knn(jnp.asarray(q), jnp.asarray(db), k))
    got = knn(T(q), T(db), k, query_chunk=64)
    np.testing.assert_array_equal(got.numpy(), want)
    d2 = ((q[:, None] - db[None]) ** 2).sum(-1)
    kth = np.sort(d2, -1)[:, k - 1:k + 1]
    assert (kth[:, 0] == kth[:, 1]).sum() > 0 or k == 1  # ties at the boundary were exercised
    # a query that is a database point finds itself or its duplicate first
    assert (d2[np.arange(150), got[:150, 0].numpy()] == 0).all()
    wi, wd = j_knn_with_distances(jnp.asarray(q), jnp.asarray(db), k)
    gi, gd = knn_with_distances(T(q), T(db), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert rel_err(gd, wd) <= 1e-6


def test_knn_is_batched():
    db = np.stack([cloud_with_duplicates(300, s) for s in (2, 3)])
    got = knn(T(db), T(db), 9)
    for f in range(2):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(j_knn(jnp.asarray(db[f]), jnp.asarray(db[f]), 9)))


def replay_level_perms(keys, sizes):
    """JAX's per-level subsampling draws of build_pyramid (pyramid.py:121-123)."""
    perms = []
    for lvl in range(1, len(sizes)):
        per_frame = []
        for key in keys:
            r = key
            for _ in range(lvl):
                r, sub = jax.random.split(r)
            per_frame.append(np.asarray(jax.random.permutation(sub, sizes[lvl - 1])[: sizes[lvl]]))
        perms.append(T(np.stack(per_frame)))
    return perms


MAPS = ("neighbors", "subsampling", "upsampling")


@pytest.mark.parametrize("ordering", ["xyz", "xz"])
@pytest.mark.parametrize("approx", [False, True])
def test_pyramid_maps_match_jax(ordering, approx):
    """need_maps=True: the three maps of every level equal JAX's, with
    JAX's own subsampling draws replayed.  JAX's pyramid runs
    ``lax.approx_min_k`` by default (approx=True), exact off the TPU but
    with its fallback sort's order on tied distances; the port keeps
    ``lax.top_k``'s rule (lower index first).  So on a cloud with
    duplicated points the port equals approx=False, and on one without
    exact ties it equals both, and there the port's build_pyramid_batched
    is held against JAX's, which runs the default."""
    sizes, k = (512, 256, 128, 64, 32), 16
    if approx:
        pts = np.stack([lidar_cloud(512, np.random.default_rng(s), extent=6.0) for s in (4, 5)])
    else:
        pts = np.stack([cloud_with_duplicates(512, s) for s in (4, 5)])
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = [j_build_pyramid(jnp.asarray(p), key, sizes, k, approx=approx, ordering=ordering)
            for p, key in zip(pts, keys)]
    perms = replay_level_perms(keys, sizes)
    got = build_pyramid(T(pts), perms, sizes, ordering, need_maps=True, neighbor_num=k)
    batched = build_pyramid_batched(T(pts), perms, sizes, k, ordering=ordering)
    for key in ("points",) + MAPS:
        assert len(got[key]) == len(want[0][key]) == (5 if key in ("points", "neighbors") else 4)
        for lvl, g in enumerate(got[key]):
            w = np.stack([np.asarray(x[key][lvl]) for x in want])
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{key}[{lvl}]")
            np.testing.assert_array_equal(batched[key][lvl].numpy(), w)
    if approx:
        j_batched = j_build_pyramid_batched(jnp.asarray(pts), jax.random.PRNGKey(3), sizes, k, ordering=ordering)
        for key in ("points",) + MAPS:
            for lvl, g in enumerate(batched[key]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(j_batched[key][lvl]), err_msg=f"{key}[{lvl}]")
    assert got["upsampling"][0].shape == (2, 512, 8)
    assert "neighbors" not in build_pyramid(T(pts), perms, sizes, ordering)


def test_approx_pyramid_differs_only_on_tied_distances():
    """The one difference from JAX's default pyramid, pinned: on a cloud
    with duplicated points, where approx_min_k's neighbour sets differ from
    the port's, they differ only by rows at the same distance."""
    sizes, k = (512, 256, 128, 64, 32), 16
    pts = cloud_with_duplicates(512, 4)
    key = jax.random.split(jax.random.PRNGKey(3), 2)[0]
    want = j_build_pyramid(jnp.asarray(pts), key, sizes, k)
    got = build_pyramid(T(pts[None]), replay_level_perms([key], sizes), sizes, "xyz", need_maps=True,
                        neighbor_num=k)
    differing = 0
    for key_ in MAPS:
        for lvl, g in enumerate(got[key_]):
            g, w = g[0].numpy(), np.asarray(want[key_][lvl])
            q = got["points"][lvl + 1 if key_ == "subsampling" else lvl][0].numpy()
            s = got["points"][lvl + 1 if key_ == "upsampling" else lvl][0].numpy()
            d2 = ((q[:, None] - s[None]) ** 2).sum(-1)
            rows = np.nonzero((g != w).any(-1))[0]
            differing += len(rows)
            for i in rows:
                np.testing.assert_array_equal(np.sort(d2[i, g[i]]), np.sort(d2[i, w[i]]))
    assert differing > 0


def test_grid_subsample_matches_jax():
    rng = np.random.default_rng(6)
    pts = lidar_cloud(900, rng, extent=5.0)
    valid = rng.uniform(size=900) > 0.2
    attrs = rng.normal(size=(900, 4)).astype(np.float32)
    for max_points in (400, 60):
        want = j_grid_subsample(jnp.asarray(pts), 0.7, max_points, jnp.asarray(valid), jnp.asarray(attrs))
        got = grid_subsample(T(pts), 0.7, max_points, T(valid), T(attrs))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2].sum() > 0
        assert rel_err(got[0], want[0]) <= 1e-6 and rel_err(got[1], want[1]) <= 1e-6
    want = j_grid_subsample(jnp.asarray(pts), 0.5, 700)
    got = grid_subsample(T(pts), 0.5, 700)
    assert got[1] is None and want[1] is None
    assert rel_err(got[0], want[0]) <= 1e-6
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_radius_search_matches_jax():
    db = cloud_with_duplicates(600, 7)
    q = cloud_with_duplicates(200, 8)
    want = np.asarray(j_radius_search(jnp.asarray(q), jnp.asarray(db), 1.1, 24))
    got = radius_search(T(q), T(db), 1.1, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 600).any() and (want < 600).any()


def test_farthest_point_sampling_matches_jax():
    """JAX draws the start index from its key (sampling.py:34); the port is
    handed that index."""
    pts = cloud_with_duplicates(800, 9)
    for seed in (0, 1):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(j_fps(jnp.asarray(pts), 64, rng))
        first = int(jax.random.randint(rng, (), 0, 800))
        got = farthest_point_sampling(T(pts), 64, first=first)
        np.testing.assert_array_equal(got.numpy(), want)
    drawn = farthest_point_sampling(T(pts), 8, generator=torch.Generator().manual_seed(0))
    assert len(set(drawn.tolist())) == 8


def test_knn_interpolate_and_global_avgpool_match_jax():
    rng = np.random.default_rng(10)
    s_pts = np.stack([lidar_cloud(120, rng, extent=3.0) for _ in range(2)])
    q_pts = np.stack([lidar_cloud(300, rng, extent=3.0) for _ in range(2)])
    feats = rng.normal(size=(2, 120, 5)).astype(np.float32)
    idx = np.stack([np.asarray(j_knn(jnp.asarray(q), jnp.asarray(s), 6)) for q, s in zip(q_pts, s_pts)])
    idx[:, ::7, 1] = 120  # shadow neighbours weigh nothing
    want = j_knn_interpolate(jnp.asarray(feats), jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(idx), 3)
    got = knn_interpolate(T(feats), T(q_pts), T(s_pts), T(idx), 3)
    assert rel_err(got, want) <= 1e-6
    mask = rng.uniform(size=(2, 120)) > 0.3
    assert rel_err(global_avgpool(T(feats)), j_global_avgpool(jnp.asarray(feats))) <= 1e-6
    assert rel_err(global_avgpool(T(feats), T(mask)), j_global_avgpool(jnp.asarray(feats), jnp.asarray(mask))) <= 1e-6


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(11)
    vals = rng.normal(size=(6, 9, 4)).astype(np.float32)
    idx = rng.integers(0, 9, size=(3, 5))
    for axis in (1, -2):
        np.testing.assert_array_equal(tgeo.index_select(T(vals), T(idx), axis).numpy(),
                                      np.asarray(jgeo.index_select(jnp.asarray(vals), jnp.asarray(idx), axis)))
    nbr = rng.integers(0, 10, size=(6, 7, 3))  # index 9 is the shadow row
    np.testing.assert_array_equal(tgeo.gather_neighbors(T(vals), T(nbr)).numpy(),
                                  np.asarray(jgeo.gather_neighbors(jnp.asarray(vals), jnp.asarray(nbr))))
    angles = rng.uniform(-np.pi, np.pi, size=(5, 3)).astype(np.float32)
    angles[0] = 0.0
    R = tgeo.euler_to_rotation(T(angles))
    assert rel_err(R, jgeo.euler_to_rotation(jnp.asarray(angles))) <= 1e-6
    t = rng.normal(size=(5, 3)).astype(np.float32)
    Tm = tgeo.se3_from_rt(R, T(t))
    jT = jgeo.se3_from_rt(jnp.asarray(R.numpy()), jnp.asarray(t))
    assert rel_err(Tm, jT) <= 1e-6
    assert rel_err(tgeo.inverse_se3(Tm), jgeo.inverse_se3(jT)) <= 1e-6
    assert rel_err(tgeo.rotation_to_rodrigues(R), jgeo.rotation_to_rodrigues(jnp.asarray(R.numpy()))) <= 1e-6
