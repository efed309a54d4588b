"""RANSAC over EPnP hypotheses, batched over frames and hypotheses
(counterpart of cofii2p_tpu/pose/ransac.py under the eval pipeline's vmap).

The hypothesis draw is an injected input: ``gumbel`` (B, H, N) noise
whose per-hypothesis top-``sample_size`` over valid rows picks the
minimal samples (Gumbel top-k = sampling without replacement).  The parity
tests pass JAX's ``jax.random.gumbel`` draws; :func:`gumbel_noise` draws
them from a ``torch.Generator`` on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.pose.epnp import epnp, refine_pose_gauss_newton, reprojection_errors


class RansacResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    inlier_mask: torch.Tensor  # (B, N) bool
    num_inliers: torch.Tensor  # (B,) int32
    success: torch.Tensor  # (B,) bool


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _gather_rows(x, idx):
    """x (B, N, D), idx (B, H, k) -> (B, H, k, D)."""
    b, h, k = idx.shape
    flat = torch.gather(x, 1, idx.reshape(b, h * k, 1).expand(-1, -1, x.shape[-1]))
    return flat.reshape(b, h, k, x.shape[-1])


def ransac_pnp(gumbel, object_points, image_points, K, mask, inlier_threshold=8.0, sample_size=6, refine_iters=2):
    """Robust PnP over fixed-size masked correspondence sets.

    gumbel (B, H, N); object_points (B, N, 3); image_points (B, N, 2);
    K (B, 3, 3); mask (B, N) validity.  success needs >= 4 inliers.
    """
    m = mask.float()
    b, h, n = gumbel.shape
    scores = torch.where(m[:, None, :] > 0, gumbel, -torch.inf)
    # top-k with ties to the lower index, like lax.top_k
    samples = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :sample_size]
    Kh = K[:, None].expand(b, h, 3, 3)
    ones = torch.ones(b, h, sample_size, dtype=torch.float32, device=gumbel.device)
    Rs, ts, _ = epnp(_gather_rows(object_points, samples), _gather_rows(image_points, samples), Kh, ones)
    err = reprojection_errors(Rs, ts, object_points[:, None], image_points[:, None], Kh)
    counts = ((err < inlier_threshold) & (m[:, None, :] > 0)).sum(-1)
    best = torch.argmax(counts, dim=-1)
    bi = torch.arange(b, device=gumbel.device)
    R, t = Rs[bi, best], ts[bi, best]

    for _ in range(refine_iters):
        err = reprojection_errors(R, t, object_points, image_points, K)
        inl = ((err < inlier_threshold) & (m > 0)).float()
        w = torch.where(inl.sum(-1, keepdim=True) >= 4, inl, m)
        R, t, _ = epnp(object_points, image_points, K, w)
        R, t = refine_pose_gauss_newton(R, t, object_points, image_points, K, w, iters=5)

    err = reprojection_errors(R, t, object_points, image_points, K)
    inlier_mask = (err < inlier_threshold) & (m > 0)
    num = inlier_mask.sum(-1).to(torch.int32)
    return RansacResult(R, t, inlier_mask, num, num >= 4)
