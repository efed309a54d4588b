"""Weighted EPnP and Gauss-Newton pose refinement, batched over leading
dims (counterpart of cofii2p_tpu/pose/epnp.py, which is written for one
problem and vmapped).

Correspondence weights replace dynamic point counts: excluded points carry
weight 0, so every problem in a batch has the same shape.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.geometry import rodrigues
from benchmark.reference.ops.small_linalg import (
    eigh3x3,
    rigid_align_weighted,
    smallest_eigvecs,
    solve3x3,
    solve_psd,
)

_EPS = 1e-9
# upper-triangle pairs of the 4 control points (jnp.triu_indices(4, k=1))
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _control_points(points, w):
    """Weighted centroid + principal-axis control points (EPnP sec. 3.1)."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=_EPS)
    c0 = torch.sum(wn[..., None] * points, dim=-2)
    centered = points - c0[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, centered, centered)
    eigval, eigvec = eigh3x3(cov)
    scale = torch.sqrt(torch.clamp(eigval, min=1e-8))
    ctrl = c0[..., None, :] + (eigvec * scale[..., None, :]).transpose(-1, -2)
    return torch.cat([c0[..., None, :], ctrl], dim=-2), eigvec, scale, c0


def _barycentric(points, eigvec, scale, c0):
    local = (points - c0[..., None, :]) @ eigvec
    a123 = local / torch.clamp(scale, min=1e-8)[..., None, :]
    return torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1)


def _pair_diffs(x):
    # integer indexing only: an index list would be a host-to-device copy,
    # which a CUDA graph capture (evaluation/pipeline.py) refuses
    return torch.stack([x[..., i, :] - x[..., j, :] for i, j in _PAIRS], dim=-2)


def _solve_betas_case1(v, ctrl_w):
    cc = v.reshape(*v.shape[:-1], 4, 3)
    dc = torch.linalg.vector_norm(_pair_diffs(cc), dim=-1)
    dw = torch.linalg.vector_norm(_pair_diffs(ctrl_w), dim=-1)
    beta = (dc * dw).sum(-1) / torch.clamp((dc * dc).sum(-1), min=_EPS)
    return beta[..., None, None] * cc


def _solve_betas_case2(v1, v2, ctrl_w):
    a = v1.reshape(*v1.shape[:-1], 4, 3)
    b = v2.reshape(*v2.shape[:-1], 4, 3)
    da, db = _pair_diffs(a), _pair_diffs(b)
    dw2 = (_pair_diffs(ctrl_w) ** 2).sum(-1)  # (..., 6)
    L = torch.stack([(da * da).sum(-1), 2.0 * (da * db).sum(-1), (db * db).sum(-1)], dim=-1)  # (..., 6, 3)
    Lt = L.transpose(-1, -2)
    ltl = Lt @ L + 1e-9 * torch.eye(3, dtype=L.dtype, device=L.device)
    sol = solve3x3(ltl, (Lt @ dw2[..., None])[..., 0])
    beta1 = torch.sqrt(torch.clamp(sol[..., 0], min=_EPS))
    beta2 = torch.sqrt(torch.clamp(sol[..., 2], min=_EPS)) * torch.sign(sol[..., 1])
    cc = beta1[..., None, None] * a + beta2[..., None, None] * b
    dc = torch.linalg.vector_norm(_pair_diffs(cc), dim=-1)
    dw = torch.sqrt(dw2)
    s = (dc * dw).sum(-1) / torch.clamp((dc * dc).sum(-1), min=_EPS)
    return s[..., None, None] * cc


def reprojection_errors(R, t, object_points, image_points, K):
    """Pixel reprojection error per correspondence; +inf behind the camera."""
    cam = object_points @ R.transpose(-1, -2) + t[..., None, :]
    uv = cam @ K.transpose(-1, -2)
    uv = uv[..., :2] / torch.clamp(uv[..., 2:3], min=_EPS)
    err = torch.linalg.vector_norm(uv - image_points, dim=-1)
    return torch.where(cam[..., 2] > 1e-6, err, torch.inf)


def _pose_from_cc(cc, alphas, object_points, image_points, K, w):
    cam_pts = alphas @ cc
    sign = torch.where((w * cam_pts[..., 2]).sum(-1) < 0, -1.0, 1.0)
    cam_pts = cam_pts * sign[..., None, None]
    R, t = rigid_align_weighted(object_points, cam_pts, w)
    err = reprojection_errors(R, t, object_points, image_points, K)
    mean_err = (w * torch.where(torch.isfinite(err), err, 1e6)).sum(-1) / torch.clamp(w.sum(-1), min=_EPS)
    return R, t, mean_err


def epnp(object_points, image_points, K, weights):
    """Weighted EPnP over (..., N, 3) / (..., N, 2) with (..., 3, 3)
    intrinsics and (..., N) weights -> (R (..., 3, 3), t (..., 3),
    mean weighted reprojection error (...))."""
    w = weights.float()
    ctrl_w, eigvec, scale, c0 = _control_points(object_points, w)
    alphas = _barycentric(object_points, eigvec, scale, c0)
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    u, v = image_points[..., 0], image_points[..., 1]
    zeros = torch.zeros_like(alphas)
    # columns interleaved control-point-major (the JAX package's perm
    # [0, 4, 8, 1, 5, 9, ...]), so that v.reshape(4, 3) gives the points
    r1 = torch.stack([alphas * fx, zeros, alphas * (cx - u)[..., None]], dim=-1).flatten(-2)
    r2 = torch.stack([zeros, alphas * fy, alphas * (cy - v)[..., None]], dim=-1).flatten(-2)
    sw = torch.sqrt(w)[..., None]
    M = torch.cat([r1 * sw, r2 * sw], dim=-2)
    vecs = smallest_eigvecs(M.transpose(-1, -2) @ M, num=2)
    v1, v2 = vecs[..., 0], vecs[..., 1]
    R1, t1, e1 = _pose_from_cc(_solve_betas_case1(v1, ctrl_w), alphas, object_points, image_points, K, w)
    R2, t2, e2 = _pose_from_cc(_solve_betas_case2(v1, v2, ctrl_w), alphas, object_points, image_points, K, w)
    pick1 = e1 <= e2
    return (
        torch.where(pick1[..., None, None], R1, R2),
        torch.where(pick1[..., None], t1, t2),
        torch.where(pick1, e1, e2),
    )


def _skew(p):
    px, py, pz = p.unbind(-1)
    o = torch.zeros_like(px)
    return torch.stack(
        [torch.stack([o, -pz, py], -1), torch.stack([pz, o, -px], -1), torch.stack([-py, px, o], -1)], -2
    )


def refine_pose_gauss_newton(R, t, object_points, image_points, K, weights, iters=10):
    """Weighted Gauss-Newton on the reprojection residuals over (omega, t)."""
    w = weights.float()
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        cam = object_points @ R.transpose(-1, -2) + t[..., None, :]
        x, y, z = cam.unbind(-1)
        z = torch.clamp(z, min=1e-6)
        r = torch.stack([fx * x / z + cx - image_points[..., 0], fy * y / z + cy - image_points[..., 1]], -1)
        zero = torch.zeros_like(z)
        J_cam = torch.stack(
            [
                torch.stack([fx / z, zero, -fx * x / z**2], -1),
                torch.stack([zero, fy / z, -fy * y / z**2], -1),
            ],
            dim=-2,
        )
        J_pose = torch.cat([-_skew(cam), eye3.expand(*cam.shape[:-1], 3, 3)], dim=-1)
        J = J_cam @ J_pose  # (..., N, 2, 6)
        Jw = J * w[..., None, None]
        H = torch.einsum("...nik,...nil->...kl", Jw, J) + 1e-6 * eye6
        g = torch.einsum("...nik,...ni->...k", Jw, r)
        delta = -solve_psd(H, g)
        R = rodrigues(delta[..., :3]) @ R
        t = t + delta[..., 3:]
    return R, t
