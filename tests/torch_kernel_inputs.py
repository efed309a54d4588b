"""Inputs shared by the card's kernel tests (tests/test_torch_cuda_kernels.py)
and the CPU tests that hold the JAX reference beside the port on the same
draws (tests/test_torch_tau_bf16_error.py), or the kernels' arithmetic
beside the plain version (tests/test_torch_ransac_host.py).  It imports no
JAX: the card runs the first file without it."""

import math

import numpy as np
import torch

from cofii2p_tpu_torch.ops.banded import _load_kernel_points, banded_knn_tau
from cofii2p_tpu_torch.ops.pyramid import morton_order
from cofii2p_tpu_torch.utils.convert import jittered_kernel_points

# encoder1_1 of the `.t7` FPN at lvl0 density: kernel #7 in bf16 at
# Cin = 4 -> 64 (ROADMAP fault F1); seeds shared with
# tests/test_torch_tau_bf16_error.py, which holds the JAX reference's bf16
# error beside the port's plain one on the same inputs
ENC1_1_SEEDS = range(6)
ENC1_1_R, ENC1_1_S, ENC1_1_K, ENC1_1_BW = 0.425, 0.2, 128, 128  # KITTIConfig's init radius, sigma, k, lvl0 plan


def enc1_1_tau_inputs(seed, n=20480, b=2):
    """(features (b, n, 4), points (b, n, 3), weights (15, 4, 64), tau
    (b, n), kernel points (15, 3)) as numpy fp32: clouds of lvl0's density
    (20480 points on 80 m x 80 m) in which one row in eight repeats
    another, with its features, as chip_smoke.py's check draws them;
    randn features and weights / 2; the layer's own jittered kernel
    points; tau over the static band (k = 128)."""
    rng = np.random.default_rng(seed)
    ext = 40.0 * np.sqrt(n / 20480)
    pts, idents = [], []
    for _ in range(b):
        base = n - n // 8
        u = rng.uniform(size=(base, 3))
        p = np.stack([u[:, 0] * 2 * ext - ext, u[:, 1] * 4 - 2, u[:, 2] * 2 * ext], -1).astype(np.float32)
        ident = np.concatenate([np.arange(base), rng.integers(0, base, n - base)])
        p = p[ident]
        order = morton_order(torch.as_tensor(p), ordering="xz").numpy()
        pts.append(p[order])
        idents.append(ident[order])
    base_f = rng.normal(size=(b, n, 4)).astype(np.float32)
    feats = [base_f[i][idents[i]] for i in range(b)]
    s = np.stack(pts)
    w = (rng.normal(size=(15, 4, 64)) / 2.0).astype(np.float32)
    kp = jittered_kernel_points(torch.tensor(_load_kernel_points(ENC1_1_R, 15), dtype=torch.float32),
                                torch.Generator().manual_seed(seed)).numpy()
    tau = banded_knn_tau(torch.as_tensor(s), torch.as_tensor(s), ENC1_1_K, 128, ENC1_1_BW).numpy()
    return np.stack(feats), s, w, tau, kp


def ransac_scene(b, n, gen, outliers=0.3, masked=0.5):
    """RANSAC's (object points, image points, K, mask) on scenes of known
    pose, as chip_smoke.py's pose phase draws them: n points 5-50 m ahead,
    0.5 px noise, a share of outlier pixels and of masked rows."""
    K = torch.tensor([[362.0, 0, 128], [0, 362.0, 40], [0, 0, 1]])
    ang = (torch.rand(b, generator=gen) * 2 - 1) * math.pi
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1), torch.stack([-s, z, c], -1)], -2)
    t = (torch.rand(b, 3, generator=gen) * 20 - 10) * torch.tensor([1.0, 0.1, 1.0])
    u = torch.rand(b, n, 3, generator=gen)
    cam = torch.stack([u[..., 0] * 40 - 20, u[..., 1] * 4 - 2, u[..., 2] * 45 + 5], -1)
    uv = cam @ K.T
    uv = uv[..., :2] / uv[..., 2:] + torch.randn(b, n, 2, generator=gen) * 0.5
    bad = torch.rand(b, n, generator=gen) < outliers
    uv = torch.where(bad[..., None], torch.rand(b, n, 2, generator=gen) * torch.tensor([256.0, 80.0]), uv)
    mask = (torch.rand(b, n, generator=gen) > masked).float()
    return (cam - t[:, None]) @ R, uv, K.expand(b, 3, 3).contiguous(), mask


def ransac_junk(b, n, gen):
    """Correspondences with no pose behind them, as seeded random weights
    give: points 10 m around 30 m ahead, random pixels, half the rows
    masked."""
    obj = torch.randn(b, n, 3, generator=gen) * 10 + torch.tensor([0.0, 0.0, 30.0])
    uv = torch.rand(b, n, 2, generator=gen) * torch.tensor([256.0, 80.0])
    K = torch.tensor([[362.0, 0, 128], [0, 362.0, 40], [0, 0, 1]]).expand(b, 3, 3).contiguous()
    return obj, uv, K, (torch.rand(b, n, generator=gen) > 0.5).float()


def ransac_degenerate(b, n, gen):
    """Degenerate sets, frame by frame in turn: 3 valid rows, no valid
    row, collinear points."""
    obj, uv, K, mask = ransac_scene(b, n, gen, masked=0.0)
    for i in range(b):
        if i % 3 == 0:
            mask[i, 3:] = 0
        elif i % 3 == 1:
            mask[i] = 0
        else:
            obj[i] = torch.linspace(0, 1, n)[:, None] * torch.tensor([4.0, 1.0, 2.0]) + torch.tensor([0.0, 0.0, 20.0])
    return obj, uv, K, mask
