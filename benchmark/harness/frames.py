"""The traffic's frames and random draws, made from the run's seed.

Scenes are a frozen copy of the port's synthetic KITTI-shaped frames
(cofii2p_tpu_torch/data/synthetic.py): a cloud sampled half inside the
camera frustum, an image whose intensity is a smooth function of the
projected points, and a ground-truth pose drawn from the configuration's
perturbation amplitudes.  Frame ``j`` of a run is a pure function of
(seed, j).  The draws of a request (the pyramid's per-level subsampling
and, when serving, the RANSAC hypothesis noise; when training, the
keypoint noise) are a pure function of (seed, request index), drawn on
the card from a ``torch.Generator`` of their own.
"""

from __future__ import annotations

import numpy as np
import torch

KEYPOINT_NOISE = ("kpt", "outline", "img_outline")


def mix(*words: int) -> int:
    """A 63-bit seed from any whole numbers (a seed may exceed 32 bits)."""
    return int(np.random.SeedSequence([int(w) & (2**64 - 1) for w in words]).generate_state(2, np.uint32)
               .astype(np.uint64) @ np.array([1, 2**32], np.uint64)) & (2**63 - 1)


def random_se3(rng: np.random.RandomState, amp: dict) -> np.ndarray:
    """Uniform random perturbation, R = Rz Ry Rx."""
    t = np.array([rng.uniform(-amp["tx"], amp["tx"]), rng.uniform(-amp["ty"], amp["ty"]),
                  rng.uniform(-amp["tz"], amp["tz"])], np.float32)
    ax, ay, az = (rng.uniform(-amp[k], amp[k]) for k in ("rx", "ry", "rz"))
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = (Rz @ Ry @ Rx).astype(np.float32)
    P[:3, 3] = t
    return P


def scene(cfg, seed: int, index: int) -> dict:
    """One frame: img (H, W, 3), pc (N, 3), attrs (N, 4) intensity and
    normal, P (4, 4), K (3, 3), all float32."""
    rng = np.random.RandomState(np.random.SeedSequence([seed, index, 777]).generate_state(1)[0])
    h, w = cfg.img_H, cfg.img_W
    fx = w * 1.2
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    n = cfg.num_pc
    n_in = n // 2
    depth = rng.uniform(4.0, 50.0, n_in)
    u = rng.uniform(2, w - 2, n_in)
    v = rng.uniform(2, h - 2, n_in)
    cam_in = np.stack([(u - K[0, 2]) / fx * depth, (v - K[1, 2]) / fx * depth, depth], -1)
    cam_out = np.stack([rng.uniform(-60, 60, n - n_in), rng.uniform(-5, 15, n - n_in),
                        rng.uniform(-40, -4, n - n_in)], -1)
    pc = np.concatenate([cam_in, cam_out]).astype(np.float32)[rng.permutation(n)]
    intensity = rng.rand(n, 1).astype(np.float32)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    attrs = np.concatenate([intensity, normals], -1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 17.0) * np.cos(yy / 9.0)], -1)
    uvz = pc @ K.T
    zs = uvz[:, 2]
    front = zs > 1e-3
    uu = (uvz[front, 0] / zs[front]).astype(np.int32)
    vv = (uvz[front, 1] / zs[front]).astype(np.int32)
    ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
    img[vv[ok], uu[ok], 2] = 1.0
    P = random_se3(rng, dict(tx=cfg.P_tx_amplitude, ty=cfg.P_ty_amplitude, tz=cfg.P_tz_amplitude,
                             rx=cfg.P_Rx_amplitude, ry=cfg.P_Ry_amplitude, rz=cfg.P_Rz_amplitude))
    return {"img": img.astype(np.float32), "pc": pc, "attrs": attrs, "P": P, "K": K}


def pool(cfg, seed: int, batches: int, batch: int, pin: bool) -> list:
    """``batches`` host batches of ``batch`` distinct frames each, in
    pinned memory when ``pin``."""
    out = []
    for i in range(batches):
        frames = [scene(cfg, seed, i * batch + j) for j in range(batch)]
        hb = {k: torch.from_numpy(np.stack([f[k] for f in frames])) for k in frames[0]}
        out.append({k: v.pin_memory() if pin else v for k, v in hb.items()})
    return out


def order(seed: int, batches: int, requests: int) -> np.ndarray:
    """The pool index of each request: the pool in a seeded order, cycled."""
    rng = np.random.RandomState(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    return np.concatenate([rng.permutation(batches) for _ in range(-(-requests // batches))])[:requests]


def generator(seed: int, request: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(mix(seed, 2, request))


def level_perms(batch: int, sizes, gen: torch.Generator, device) -> list:
    """For level l a random subset of ``sizes[l]`` indices into level l-1,
    in random order."""
    perms = []
    for lvl in range(1, len(sizes)):
        keys = torch.rand(batch, sizes[lvl - 1], generator=gen, device=device)
        perms.append(torch.argsort(keys, dim=-1)[:, : sizes[lvl]])
    return perms


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def serve_draws(cfg, batch: int, seed: int, request: int, device) -> dict:
    gen = generator(seed, request, device)
    return {"perms": level_perms(batch, cfg.pyramid_sizes, gen, device),
            "gumbel": gumbel((batch, cfg.ransac_hypotheses, cfg.num_superpoints), gen, device)}


def train_draws(cfg, batch: int, seed: int, step: int, device) -> dict:
    gen = generator(seed, step, device)
    s, l = cfg.num_superpoints, cfg.num_img_tokens
    shapes = {"kpt": (batch, s), "outline": (batch, s), "img_outline": (batch, l)}
    return {"perms": level_perms(batch, cfg.pyramid_sizes, gen, device),
            "keypoint_noise": {k: gumbel(shapes[k], gen, device) for k in KEYPOINT_NOISE}}
