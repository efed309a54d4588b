"""Dense geometry primitives (counterpart of cofii2p_tpu/ops/geometry.py).

Batch-agnostic: every function works on the trailing dims and broadcasts
over leading ones.
"""

from __future__ import annotations

import torch

_EPS_DIST = 1e-12


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """Squared distances (..., N, D) x (..., M, D) -> (..., N, M) by the
    matmul identity ||a||^2 + ||b||^2 - 2<a, b>."""
    inner = torch.einsum("...nd,...md->...nm", a, b)
    sq = (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] - 2.0 * inner
    if clamp:
        sq = torch.clamp(sq, min=_EPS_DIST)
    return sq


def point2node(nodes: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Index of the nearest node (..., M, 3) for each point (..., N, 3);
    first minimum on ties, like ``jnp.argmin``."""
    return torch.argmin(pairwise_sq_dist(points, nodes), dim=-1)


def apply_se3(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) SE(3) transforms to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    k = rvec / torch.clamp(theta, min=1e-12)
    kx, ky, kz = k.unbind(-1)
    zeros = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zeros, -kz, ky], -1),
            torch.stack([kz, zeros, -kx], -1),
            torch.stack([-ky, kx, zeros], -1),
        ],
        -2,
    )
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th > 1e-12, R, eye)


def project_points(K: torch.Tensor, points_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection (..., 3, 3) x (..., N, 3) -> (..., N, 2) pixels."""
    uvw = torch.einsum("...ij,...nj->...ni", K, points_cam)
    return uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-12)
