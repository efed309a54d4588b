"""Closed-form small-matrix linear algebra for the pose solvers
(counterpart of cofii2p_tpu/ops/small_linalg.py).

The same straight-line formulas as the JAX package (Cardano eigenvalues,
unrolled Cholesky, Horn's quaternion alignment) rather than torch.linalg,
so the port's RANSAC agrees with the reference given the same samples.
Batch-agnostic over leading dims.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _det3x3(M):
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _norm_sq(v, dim=-1):
    return torch.sum(v * v, dim=dim, keepdim=True)


def eigh3x3(A: torch.Tensor):
    """Symmetric (..., 3, 3) eigendecomposition, ascending:
    (eigvals (..., 3), eigvecs (..., 3, 3) as columns)."""
    A = 0.5 * (A + A.transpose(-1, -2))
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    Aq = A - q[..., None, None] * _eye(3, A)
    p2 = torch.sum(Aq * Aq, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    B = Aq / p[..., None, None]
    r = torch.clamp(_det3x3(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = torch.stack([e3, e2, e1], dim=-1)

    def eigvec(lam):
        M = A - lam[..., None, None] * _eye(3, A)
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cands = torch.stack(
            [torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2), torch.linalg.cross(r1, r2)], dim=-2
        )
        best = torch.argmax(torch.sum(cands * cands, dim=-1), dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
        n = torch.sqrt(torch.clamp(_norm_sq(v), min=_EPS))
        fallback = _eye(3, A)[0].expand(v.shape)
        return torch.where(n > 1e-6, v / n, fallback)

    v0 = eigvec(vals[..., 0])
    v2 = eigvec(vals[..., 2])
    v2 = v2 - torch.sum(v2 * v0, -1, keepdim=True) * v0
    n2 = torch.sqrt(torch.clamp(_norm_sq(v2), min=_EPS))
    ey = _eye(3, A)[1].expand(v0.shape)
    alt = torch.linalg.cross(v0, ey)
    altn = alt / torch.sqrt(torch.clamp(_norm_sq(alt), min=_EPS))
    v2 = torch.where(n2 > 1e-6, v2 / n2, altn)
    v1 = torch.linalg.cross(v2, v0)
    return vals, torch.stack([v0, v1, v2], dim=-1)


def cholesky_unrolled(A: torch.Tensor, n: int) -> torch.Tensor:
    """Cholesky of a PD (..., n, n) matrix, statically unrolled."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=_EPS))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack(
        [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1) for i in range(n)], dim=-2
    )


def cho_solve_unrolled(L: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = A.shape[-1]
    return cho_solve_unrolled(cholesky_unrolled(A, n), b, n)


def smallest_eigvecs(A: torch.Tensor, num: int = 2, shift: float = 1e-4, iters: int = 8):
    """The ``num`` smallest-eigenvalue eigenvectors of a symmetric PSD
    (..., n, n) matrix by shifted inverse iteration with deflation."""
    n = A.shape[-1]
    scale = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n, min=1.0)
    L = cholesky_unrolled(A + (shift * scale)[..., None, None] * _eye(n, A), n)
    vecs = []
    for j in range(num):
        v = (_eye(n, A)[:, j % n] + 0.1).expand(*A.shape[:-2], n)
        for _ in range(iters):
            for u in vecs:
                v = v - torch.sum(v * u, -1, keepdim=True) * u
            v = cho_solve_unrolled(L, v, n)
            v = v / torch.sqrt(torch.clamp(_norm_sq(v), min=_EPS))
        for u in vecs:
            v = v - torch.sum(v * u, -1, keepdim=True) * u
        v = v / torch.sqrt(torch.clamp(_norm_sq(v), min=_EPS))
        vecs.append(v)
    return torch.stack(vecs, dim=-1)


def _det3(a, idx_r, idx_c):
    r0, r1, r2 = idx_r
    c0, c1, c2 = idx_c
    return (
        a[..., r0, c0] * (a[..., r1, c1] * a[..., r2, c2] - a[..., r1, c2] * a[..., r2, c1])
        - a[..., r0, c1] * (a[..., r1, c0] * a[..., r2, c2] - a[..., r1, c2] * a[..., r2, c0])
        + a[..., r0, c2] * (a[..., r1, c0] * a[..., r2, c1] - a[..., r1, c1] * a[..., r2, c0])
    )


def _adj4(A: torch.Tensor) -> torch.Tensor:
    """Adjugate of a (..., 4, 4) matrix via cofactors."""
    idx = [0, 1, 2, 3]
    cols = []
    for j in range(4):
        col = []
        for i in range(4):
            sign = -1.0 if (i + j) % 2 else 1.0
            col.append(sign * _det3(A, [r for r in idx if r != i], [c for c in idx if c != j]))
        cols.append(torch.stack(col, dim=-1))
    return torch.stack(cols, dim=-2)


def rigid_align_weighted(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment dst ~= R src + t by Horn's quaternion method
    (power iteration + adjugate polish, no SVD).  src, dst (..., N, 3),
    w (..., N)."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=_EPS)
    mu_s = torch.einsum("...n,...ni->...i", wn, src)
    mu_d = torch.einsum("...n,...ni->...i", wn, dst)
    S = torch.einsum("...n,...ni,...nj->...ij", wn, src - mu_s[..., None, :], dst - mu_d[..., None, :])
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        dim=-2,
    )
    fro = torch.sqrt(torch.clamp(torch.sum(N * N, dim=(-2, -1)), min=_EPS))
    M = N + fro[..., None, None] * _eye(4, N)
    P = M @ M @ M
    Pn = P / torch.sqrt(torch.clamp(torch.sum(P * P, dim=-2, keepdim=True), min=_EPS))
    ray = torch.einsum("...ij,...ik,...kj->...j", Pn, N, Pn)
    best = torch.argmax(ray, dim=-1)
    q = torch.gather(Pn, -1, best[..., None, None].expand(*best.shape, 4, 1))[..., 0]
    for _ in range(6):
        q = torch.einsum("...ij,...j->...i", M, q)
        q = q / torch.sqrt(torch.clamp(_norm_sq(q), min=_EPS))
    for _ in range(2):
        lam = torch.einsum("...i,...ij,...j->...", q, N, q)
        A = N - (lam + 1e-6 * fro)[..., None, None] * _eye(4, N)
        q = torch.einsum("...ij,...j->...i", _adj4(A), q)
        q = q / torch.sqrt(torch.clamp(_norm_sq(q), min=_EPS))
    w0, x, y, z = q.unbind(-1)
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w0), 2 * (x * z + y * w0)], -1),
            torch.stack([2 * (x * y + z * w0), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w0)], -1),
            torch.stack([2 * (x * z - y * w0), 2 * (y * z + x * w0), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    return R, t


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) solve of (..., 3, 3) systems."""
    c0 = torch.linalg.cross(A[..., :, 1], A[..., :, 2])
    c1 = torch.linalg.cross(A[..., :, 2], A[..., :, 0])
    c2 = torch.linalg.cross(A[..., :, 0], A[..., :, 1])
    det = torch.sum(A[..., :, 0] * c0, dim=-1)
    safe = torch.where(det.abs() > _EPS, det, torch.where(det >= 0, _EPS, -_EPS))
    inv_det = 1.0 / safe
    return torch.stack(
        [torch.sum(c0 * b, -1) * inv_det, torch.sum(c1 * b, -1) * inv_det, torch.sum(c2 * b, -1) * inv_det],
        dim=-1,
    )
