"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go to both sides, JAX's random draws are
replayed and handed to the port, and outputs are compared as numpy."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cofii2p_tpu.config as jconfig
from cofii2p_tpu.ops.pyramid import morton_order
import cofii2p_tpu_torch.config as tconfig
from cofii2p_tpu_torch.data.loader import _collate
from cofii2p_tpu_torch.data.synthetic import SyntheticDataset


def cpu_threads(worker_count: int | None, cpu_count: int) -> int | None:
    """PyTorch's intra-op threads for each of ``worker_count`` pytest-xdist
    workers on ``cpu_count`` cores: an equal share, at least one.  None
    outside xdist (``worker_count`` None): PyTorch's default stands."""
    if worker_count is None:
        return None
    return max(1, cpu_count // worker_count)


def usable_cores() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()


def xdist_workers() -> int | None:
    """The count of pytest-xdist workers this process is one of, or None."""
    count = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    return int(count) if count else None


# Left alone, each xdist worker's intra-op pool takes a thread per core, and
# the workers' threads spin on each other's cores.  Every xdist worker
# collects, and so imports, every test module before it runs any test, so
# this budget holds for the whole worker, the JAX package's tests included.
_threads = cpu_threads(xdist_workers(), usable_cores())
if _threads is not None:
    torch.set_num_threads(_threads)


def cfg_pair(name: str = "TinyConfig", **overrides):
    """The same configuration as a JAX-package and a port config object."""
    return getattr(jconfig, name)(**overrides), getattr(tconfig, name)(**overrides)


def host_batch(cfg, batch: int, start: int = 0) -> dict:
    """Synthetic frames as numpy (the port's numpy copy of the dataset)."""
    ds = SyntheticDataset(cfg, "val", length=start + batch)
    hb = _collate([ds[start + i] for i in range(batch)])
    hb.pop("index")
    return hb


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.as_tensor(np.asarray(tree))


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x)


def rel_err(a, ref) -> float:
    """max |a - ref| / max(|ref|, rms(ref)): relative error with an rms
    floor, so entries near zero are judged on the tensor's scale."""
    a = np.asarray(to_numpy(a), np.float64)
    ref = np.asarray(to_numpy(ref), np.float64)
    rms = float(np.sqrt(np.mean(ref**2))) + 1e-30
    return float(np.max(np.abs(a - ref) / np.maximum(np.abs(ref), rms)))


def jax_variables(jcfg, hb: dict, seed: int = 0, has_normals: bool = True):
    """Initialise the JAX CoFiI2P on one batch, then perturb every norm
    scale/bias and BatchNorm statistic so a mis-mapped weight shows up.
    Returns (model, params, batch_stats) as numpy trees."""
    from cofii2p_tpu.data.device_pipeline import prepare_samples
    from cofii2p_tpu.models import CoFiI2P

    model = CoFiI2P(jcfg)
    batch = prepare_samples(
        jnp.asarray(hb["pc"]), jnp.asarray(hb["attrs"]), jnp.asarray(hb["P"]),
        jnp.asarray(hb["K"]), jax.random.PRNGKey(0), jnp.asarray(hb["img"]), jcfg, has_normals=has_normals,
    )
    variables = jax.jit(model.init, static_argnames=("mode", "train"))(
        jax.random.PRNGKey(seed), batch, mode="train", train=True
    )
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if "kernel_points" in name:
            return x
        if name.endswith("['scale']") or name.endswith("['var']"):
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if name.endswith("['bias']") or name.endswith("['mean']"):
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(perturb, variables.get("batch_stats", {}))
    return model, params, stats


def per_layer_kernel_points(params, seed=0):
    """Each KPConv's kernel points rotated and jittered independently
    (utils/convert.py::jittered_kernel_points), in a JAX parameter tree."""
    from cofii2p_tpu_torch.utils.convert import jittered_kernel_points

    gen = torch.Generator().manual_seed(seed)

    def perturb(path, x):
        if "kernel_points" not in jax.tree_util.keystr(path):
            return np.asarray(x)
        return jittered_kernel_points(torch.tensor(np.asarray(x)), gen).numpy()

    return jax.tree_util.tree_map_with_path(perturb, params)


def replay_prep_draws(jcfg, prep_rng, batch: int) -> dict:
    """JAX's random draws of one prepare_samples call, replayed from its key
    splits (device_pipeline.py:56,103-116,183-184, pyramid.py:121-123): the
    per-level subsampling permutations (B, N_l) and the Gumbel noise of the
    three keypoint draws."""
    sizes = jcfg.pyramid_sizes
    perms = [[] for _ in sizes[1:]]
    noise = {"kpt": [], "outline": [], "img_outline": []}
    for key in jax.random.split(prep_rng, batch):
        r_pyr, r_kpt, r_out, r_imgout = jax.random.split(key, 4)
        for lvl in range(1, len(sizes)):
            r_pyr, sub = jax.random.split(r_pyr)
            perms[lvl - 1].append(np.asarray(jax.random.permutation(sub, sizes[lvl - 1])[: sizes[lvl]]))
        noise["kpt"].append(np.asarray(jax.random.gumbel(r_kpt, (jcfg.num_superpoints,))))
        noise["outline"].append(np.asarray(jax.random.gumbel(r_out, (jcfg.num_superpoints,))))
        noise["img_outline"].append(np.asarray(jax.random.gumbel(r_imgout, (jcfg.num_img_tokens,))))
    return {
        "perms": [torch.as_tensor(np.stack(p)) for p in perms],
        "keypoint_noise": {k: torch.as_tensor(np.stack(v)) for k, v in noise.items()},
    }


def replay_draws(jcfg, rng, batch: int) -> dict:
    """JAX's random draws of one make_eval_body call, replayed from its key
    splits (pipeline.py:41, ransac.py:73): the sample-prep draws and the
    RANSAC Gumbel noise (B, H, S)."""
    prep_rng, ransac_rng = jax.random.split(rng)
    gumbel = np.stack([
        np.asarray(jax.random.gumbel(k, (jcfg.ransac_hypotheses, jcfg.num_superpoints)))
        for k in jax.random.split(ransac_rng, batch)
    ])
    return {"perms": replay_prep_draws(jcfg, prep_rng, batch)["perms"], "gumbel": torch.as_tensor(gumbel)}


def replay_train_draws(jcfg, rng, step: int, batch: int) -> dict:
    """JAX's draws of train step ``step`` (train_lib.py:122): the sample-prep
    key is the first half of split(fold_in(rng, step))."""
    prep_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    return replay_prep_draws(jcfg, prep_rng, batch)


def lidar_cloud(n, rng, extent=40.0, far=0):
    """Ground-plane-dominated cloud (x, z spread, y thin); ``far`` points
    sit in a distant cluster so some query tiles have sparse support."""
    pts = np.concatenate(
        [rng.uniform(-extent, extent, (n, 1)), rng.uniform(-2, 2, (n, 1)), rng.uniform(0, 2 * extent, (n, 1))], 1
    )
    if far:
        pts[:far] = rng.normal(0, 0.5, (far, 3)) + np.array([300.0, 0.0, 300.0])
    return pts.astype(np.float32)


def ordered_idx(pts):
    """The JAX package's Morton order of a cloud."""
    return np.asarray(morton_order(jnp.asarray(pts), ordering="xz"))


def ordered(pts):
    return pts[ordered_idx(pts)]


def config_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


MARGIN = 1e-5  # decision margin below which discrete eval outputs may differ


def top2_gap(x, axis):
    """Gap between the maximum and the largest value below it.  Exact
    duplicates (border-clamped patch cells repeat a pixel) tie on both
    sides and resolve to the first index alike, so they are no margin."""
    x = np.asarray(x, np.float64)
    top = x.max(axis=axis, keepdims=True)
    below = np.where(x < top, x, -np.inf).max(axis=axis, keepdims=True)
    return np.squeeze(top - below, axis=axis)


def jax_test_mode(jcfg, jmodel, params, stats, jhb, rng, fpn=None, has_normals=True):
    """The JAX model's test-mode outputs inside one make_eval_body call
    with key ``rng`` (its sample-prep key), and with ``fpn`` (a JAX
    KPConvFPN) also that FPN's outputs on the same batch, under "fpn"."""
    from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare

    @jax.jit
    def run(params, stats, hb, rng):
        batch = j_prepare(hb["pc"], hb["attrs"], hb["P"], hb["K"], jax.random.split(rng)[0], hb["img"], jcfg,
                          has_normals=has_normals)
        out = jmodel.apply({"params": params, "batch_stats": stats}, batch, mode="test", train=False)
        if fpn is not None:
            out["fpn"] = fpn.apply({"params": params["pc_encoder"]}, batch["feats"], batch["points"])
        return out

    return run(params, stats, jhb, rng)


def assert_eval_outputs_match(jcfg, jout, want, got, b):
    """The port's EvalOutput ``got`` against JAX's ``want``: continuous
    fields to 1e-3 (relative, rms-floored); discrete fields wherever the
    JAX side's decision has a margin above MARGIN (coarse and fine top-2
    gaps, score-to-threshold gaps, from its test-mode outputs ``jout``), and
    whole-frame results wherever no superpoint of the frame sits inside
    such a margin."""
    from cofii2p_tpu.models.network import l2norm as j_l2norm

    img_flat = np.asarray(jout["img_feature_norm"]).reshape(b, jcfg.num_img_tokens, -1)
    sim = np.einsum("blc,bsc->bls", img_flat, np.asarray(jout["pc_feature_norm"]))
    cells = np.asarray(j_l2norm(jout["fine_img_patch"].reshape(b, jcfg.num_superpoints, 16, -1)))
    cos = np.einsum("bspc,bsc->bsp", cells, np.asarray(j_l2norm(jout["fine_pc_feature"])))
    thrs = jcfg.test_score_thresholds_start - jcfg.test_score_thresholds_step * np.arange(
        jcfg.test_score_thresholds_num, dtype=np.float32)
    score_gap = np.abs(np.asarray(want.pc_score)[..., None] - thrs).min(-1)
    clear = (top2_gap(sim, 1) > MARGIN) & (top2_gap(cos, -1) > MARGIN) & (score_gap > MARGIN)  # (B, S)
    frames = clear.all(-1)
    print(f"superpoints inside a {MARGIN} decision margin: {int((~clear).sum())} of {clear.size}; "
          f"frames compared whole: {int(frames.sum())} of {b}")
    assert frames.sum() >= 1

    np.testing.assert_allclose(got.P_gt.numpy(), np.asarray(want.P_gt), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.object_points.numpy(), np.asarray(want.object_points))
    assert rel_err(got.pc_score, want.pc_score) <= 1e-3
    np.testing.assert_array_equal(got.corr_mask.numpy()[clear], np.asarray(want.corr_mask)[clear])
    np.testing.assert_array_equal(got.fine_xy.numpy()[clear], np.asarray(want.fine_xy)[clear])
    for f in np.flatnonzero(frames):
        np.testing.assert_array_equal(got.success[f].numpy(), np.asarray(want.success)[f])
        np.testing.assert_array_equal(got.num_inliers[f].numpy(), np.asarray(want.num_inliers)[f])
        np.testing.assert_allclose(got.R[f].numpy(), np.asarray(want.R)[f], rtol=0, atol=1e-3, equal_nan=True)
        wt, gt = np.asarray(want.t)[f], got.t[f].numpy()
        np.testing.assert_allclose(gt, wt, rtol=1e-3, atol=1e-3 * max(1.0, float(np.nan_to_num(np.abs(wt)).max())),
                                   equal_nan=True)
