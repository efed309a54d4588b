"""Kernel-point disposition (counterpart of cofii2p_tpu/models/kernel_points.py).

K points in the unit ball placed by a seeded simulation of pairwise
repulsion plus a central attraction, point 0 pinned at the centre, then
rescaled so the mean radius of the others is 0.66 (KPConv, Thomas et al.,
arXiv:1904.08889).  The port ships the 15-point disposition in
``dispositions/k_015_3d.npy`` beside this module, a byte-identical copy of
the JAX package's file, and generates any other size in memory with the
same numpy simulation; it writes no file.
"""

from __future__ import annotations

import functools
import os

import numpy as np

# the shipped disposition files are data that the program and this
# reference both read
_DISPOSITIONS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "cofii2p_tpu_torch", "models", "dispositions",
)
_SEED = 1337
_RATIO = 0.66  # mean radius of the non-centre points at unit scale


def _simulate(num_points: int, dimension: int, seed: int, iters: int = 10000) -> np.ndarray:
    """The seeded repulsion simulation (cofii2p_tpu/models/kernel_points.py:
    26-56), float64, unit scale."""
    rng = np.random.RandomState(seed)
    # rejection-sample initial points inside the ball of radius sqrt(0.5)
    pts = np.empty((0, dimension))
    while pts.shape[0] < num_points:
        cand = rng.uniform(-1.0, 1.0, size=(4 * num_points, dimension))
        cand = cand[np.sum(cand**2, axis=1) < 0.5]
        pts = np.concatenate([pts, cand], axis=0)
    pts = pts[:num_points]
    pts[0] = 0.0  # pinned center

    step = 1e-2
    decay = 0.9995
    clip = 0.05
    prev_norms = np.zeros(num_points)
    for _ in range(iters):
        diff = pts[:, None, :] - pts[None, :, :]
        sq = np.sum(diff**2, axis=-1)
        # repulsion ~ 1/d^2 directed along diff, plus central spring
        grad = np.sum(diff / (sq[..., None] ** 1.5 + 1e-6), axis=1) + 10.0 * pts
        norms = np.linalg.norm(grad, axis=-1)
        if np.max(np.abs(norms[1:] - prev_norms[1:])) < 1e-5:
            break
        prev_norms = norms
        move = np.minimum(step * norms, clip)
        move[0] = 0.0
        pts = pts - move[:, None] * grad / (norms[:, None] + 1e-6)
        step *= decay
    return pts


def generate_disposition(num_points: int, dimension: int = 3) -> np.ndarray:
    """:func:`_simulate` with the package seed, rescaled to a mean non-centre
    radius of 0.66, as float32 (kernel_points.py:58-72)."""
    pts = _simulate(num_points, dimension, _SEED)
    radii = np.linalg.norm(pts, axis=-1)
    return (pts * (_RATIO / np.mean(radii[1:]))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def kernel_dispositions(num_points: int = 15, dimension: int = 3) -> np.ndarray:
    """Unit-scale disposition (num_points, dimension) float32, point 0 at
    the origin: the shipped file where there is one, else generated."""
    path = os.path.join(_DISPOSITIONS, f"k_{num_points:03d}_{dimension}d.npy")
    if os.path.exists(path):
        return np.load(path)
    return generate_disposition(num_points, dimension)


def load_kernel_points(radius: float, num_points: int = 15, dimension: int = 3) -> np.ndarray:
    """Disposition scaled to the conv radius (same arithmetic as the JAX
    package: float32 array times a Python float)."""
    return kernel_dispositions(num_points, dimension) * radius
