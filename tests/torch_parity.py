"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go to both sides, JAX's random draws are
replayed and handed to the port, and outputs are compared as numpy."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cofii2p_tpu.config as jconfig
from cofii2p_tpu.ops.pyramid import morton_order
import cofii2p_tpu_torch.config as tconfig
from cofii2p_tpu_torch.data.loader import _collate
from cofii2p_tpu_torch.data.synthetic import SyntheticDataset


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


def jax_variables(jcfg, hb: dict, seed: int = 0):
    """Initialise the JAX CoFiI2P on one batch, then perturb every norm
    scale/bias and BatchNorm statistic so a mis-mapped weight shows up.
    Returns (model, params, batch_stats) as numpy trees."""
    from cofii2p_tpu.data.device_pipeline import prepare_samples
    from cofii2p_tpu.models import CoFiI2P

    model = CoFiI2P(jcfg)
    batch = prepare_samples(
        jnp.asarray(hb["pc"]), jnp.asarray(hb["attrs"]), jnp.asarray(hb["P"]),
        jnp.asarray(hb["K"]), jax.random.PRNGKey(0), jnp.asarray(hb["img"]), jcfg,
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


def ordered(pts):
    return pts[np.asarray(morton_order(jnp.asarray(pts), ordering="xz"))]


def config_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
