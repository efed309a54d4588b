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


def fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, as XLA's CPU backend compiles a
    jitted small dot or sum of products: ``x0*y0`` rounded to fp32, then
    each next product added by a fused multiply-add.  The fused steps are
    emulated in float64, where the product of two fp32 values is exact:
    each sum is rounded twice, to float64 and then to fp32, where a fused
    multiply-add rounds once, so a sum that float64 rounds onto the midpoint
    of two fp32 values can land one fp32 step away from XLA's (the parity
    tests meet no such sum on their draws).  The same on every device, and
    no matmul (and so no TF32) takes part.  x, y broadcast; returns fp32."""
    x64, y64 = x.double(), y.double()
    r = (x64[..., 0] * y64[..., 0]).float()
    for d in range(1, x.shape[-1]):
        r = (x64[..., d] * y64[..., d] + r.double()).float()
    return r


def index_select(values: torch.Tensor, indices: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Rows of ``values`` along ``axis`` by an index tensor of any shape:
    values.shape[:axis] + indices.shape + values.shape[axis+1:]
    (cofii2p_tpu/ops/geometry.py:75-82)."""
    axis = axis % values.ndim
    out = torch.index_select(values, axis, indices.reshape(-1).long())
    return out.reshape(values.shape[:axis] + indices.shape + values.shape[axis + 1:])


def gather_neighbors(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Batched neighbour gather: values (..., N, C), indices (..., M, H) ->
    (..., M, H, C); index N addresses a row of zeros, the reference's
    shadow point (cofii2p_tpu/ops/geometry.py:85-99)."""
    n, c = values.shape[-2:]
    lead = indices.shape[:-2]
    flat = indices.reshape(*lead, -1).long()  # (..., M*H)
    out = torch.gather(values.expand(*lead, n, c), -2, flat.clamp(0, n - 1)[..., None].expand(*flat.shape, c))
    out.masked_fill_((flat >= n)[..., None], 0.0)  # gather's backward keeps only the indices
    return out.reshape(*indices.shape, c)


def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from (..., 3, 3) rotations and (..., 3) translations."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) SE(3) transforms: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def rotation_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    axis = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1
    )
    sin_t = torch.sin(theta)
    scale = torch.where(sin_t > 1e-7, theta / (2.0 * torch.clamp(sin_t, min=1e-12)), 0.5)
    return axis * scale[..., None]


def euler_to_rotation(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) as (rx, ry, rz) -> R = Rz @ Ry @ Rx, the
    reference augmentation's convention."""
    cx, sx = torch.cos(angles[..., 0]), torch.sin(angles[..., 0])
    cy, sy = torch.cos(angles[..., 1]), torch.sin(angles[..., 1])
    cz, sz = torch.cos(angles[..., 2]), torch.sin(angles[..., 2])
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([(one, zero, zero), (zero, cx, -sx), (zero, sx, cx)])
    Ry = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    Rz = mat([(cz, -sz, zero), (sz, cz, zero), (zero, zero, one)])
    return Rz @ Ry @ Rx
