"""Morton-ordered point pyramid (counterpart of cofii2p_tpu/ops/pyramid.py).

The banded KPConv paths need the levels alone: no k-NN index maps.

The random per-level subsampling is an injected input: ``perms[l-1]``
holds, for every frame, the indices of level l-1 kept at level l (the
first ``sizes[l]`` entries of a random permutation).  The parity tests
hand in JAX's own ``jax.random.permutation`` draws; on the card
:func:`random_level_perms` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _spread2(v: torch.Tensor) -> torch.Tensor:
    """Interleave 15 bits with 1-bit gaps."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Interleave 10 bits with 2-bit gaps."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_order(points: torch.Tensor, voxel: float = 0.4, ordering: str = "xyz") -> torch.Tensor:
    """Permutation (..., N) sorting (..., N, 3) points along a Z-order curve.

    'xz' interleaves the ground-plane axes (15 bits each), 'xyz' all three
    (10 bits each).  The sort is stable, as ``jnp.argsort`` is, so equal
    codes keep their input order on both sides.
    """
    lo = points.amin(dim=-2, keepdim=True)
    scaled = ((points - lo) / voxel).to(torch.int32)
    if ordering == "xz":
        q = torch.clamp(scaled, 0, (1 << 15) - 1)
        code = _spread2(q[..., 0]) | (_spread2(q[..., 2]) << 1)
    elif ordering == "xyz":
        q = torch.clamp(scaled, 0, (1 << 10) - 1)
        code = _spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1) | (_spread3(q[..., 2]) << 2)
    else:
        raise ValueError(f"ordering {ordering!r} is not 'xz' or 'xyz'")
    return torch.sort(code, dim=-1, stable=True).indices


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: (B, N, D), (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def random_level_perms(batch: int, sizes: Sequence[int], generator: torch.Generator, device) -> list:
    """Per-level subsampling draws from ``generator``: for level l a random
    subset of ``sizes[l]`` indices into level l-1, in random order."""
    perms = []
    for lvl in range(1, len(sizes)):
        keys = torch.rand(batch, sizes[lvl - 1], generator=generator, device=device)
        perms.append(torch.argsort(keys, dim=-1)[:, : sizes[lvl]])
    return perms


def build_pyramid(points: torch.Tensor, perms: Sequence[torch.Tensor], sizes: Sequence[int],
                  ordering: str = "xyz") -> dict:
    """Morton-sorted pyramid levels for a batch of clouds.

    points (B, N0, 3) with N0 == sizes[0]; perms as in the module docstring.
    Returns {'points': [(B, N_l, 3)], 'lengths': sizes, 'perm0': (B, N0)}
    (cofii2p_tpu/ops/pyramid.py:88-169 without the maps).
    """
    if points.shape[1] != sizes[0]:
        raise ValueError(f"cloud of {points.shape[1]} points, pyramid expects {sizes[0]}")
    perm0 = morton_order(points, ordering=ordering)
    levels = [_take(points, perm0)]
    for lvl in range(1, len(sizes)):
        sub = _take(levels[-1], perms[lvl - 1][:, : sizes[lvl]].long())
        levels.append(_take(sub, morton_order(sub, ordering=ordering)))
    return {"points": levels, "lengths": list(sizes), "perm0": perm0}
