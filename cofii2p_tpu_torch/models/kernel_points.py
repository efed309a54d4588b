"""Kernel-point disposition (counterpart of cofii2p_tpu/models/kernel_points.py).

The JAX package generates the 15-point disposition deterministically and
caches it in ``cofii2p_tpu/models/dispositions/k_015_3d.npy``, a tracked
file.  The port ships a byte-identical copy in its own
``dispositions/`` beside this module, so both packages convolve with
bit-identical kernel points and the port reads nothing of the JAX tree.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DISPOSITIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dispositions")


@functools.lru_cache(maxsize=None)
def kernel_dispositions(num_points: int = 15, dimension: int = 3) -> np.ndarray:
    """Unit-scale disposition (num_points, dimension) float32, point 0 at
    the origin."""
    path = os.path.join(_DISPOSITIONS, f"k_{num_points:03d}_{dimension}d.npy")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: only the shipped (15, 3) disposition exists"
        )
    return np.load(path)


def load_kernel_points(radius: float, num_points: int = 15, dimension: int = 3) -> np.ndarray:
    """Disposition scaled to the conv radius (same arithmetic as the JAX
    package: float32 array times a Python float)."""
    return kernel_dispositions(num_points, dimension) * radius
