"""On-device sample preparation (counterpart of
cofii2p_tpu/data/device_pipeline.py::prepare_samples).

Perturbs each cloud by its pose, assembles the point features, builds the
Morton-ordered pyramid (with its k-NN maps under ``kpconv_impl='gather'``)
and the /2 intrinsics, and inverts the pose into the ground truth.  Given ``keypoint_noise``, it also derives the training
supervision: in-view and out-of-view superpoint keypoints, the /8 image
occupancy and keypoint cells, and the fine /2 targets.  The random draws
are inputs, as the pyramid permutations are: the parity tests hand in
JAX's own Gumbel noise, the trainer draws it from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.ops.geometry import apply_se3, point2node, project_points
from cofii2p_tpu_torch.ops.pyramid import build_pyramid

KEYPOINT_NOISE = ("kpt", "outline", "img_outline")


def masked_choice(gumbel: torch.Tensor, mask: torch.Tensor, k: int):
    """k distinct indices drawn uniformly from {i : mask[i]} by Gumbel top-k
    over the last axis (device_pipeline.py:29-39), given the Gumbel noise.

    Returns (indices (..., k) int64, valid (..., k) bool).  With fewer than
    k valid entries the tail comes from invalid ones and is flagged False.
    In fp32 ``g - 1e9`` rounds every masked entry to the same value, and
    ``lax.top_k`` takes tied entries lowest index first; a stable
    descending sort does the same (``torch.topk`` promises no tie order).
    """
    scores = torch.where(mask, gumbel, gumbel - 1e9)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    return idx, torch.gather(mask, -1, idx)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: (B, N, D), (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _clamp_xy(xy: torch.Tensor, x_max: float, y_max: float) -> torch.Tensor:
    """(..., 2) pixel coordinates clamped to [0, x_max] x [0, y_max], a
    column at a time with scalar bounds (min and max are exact: the bits of
    a clamp to a bounds tensor, without copying one from the host)."""
    return torch.stack([xy[..., 0].clamp(0.0, x_max), xy[..., 1].clamp(0.0, y_max)], dim=-1)


def _supervision(cfg: Config, P, K, points, noise) -> Dict[str, torch.Tensor]:
    """The training fields of _prepare_one (device_pipeline.py:74-150),
    batched over frames."""
    superpoints = points[-1]  # (B, S, 3)
    b = superpoints.shape[0]
    # ground-truth projection back to the camera: x_cam = P^-1 x_w
    pinv_r = P[:, :3, :3].transpose(-1, -2)
    cam_sp = torch.einsum("bij,bnj->bni", pinv_r, superpoints) - (pinv_r @ P[:, :3, 3:4])[..., 0][:, None]
    K4 = K * 0.125
    K4[:, 2, 2] = 1.0
    K2 = K * 0.5
    K2[:, 2, 2] = 1.0

    h8, w8 = cfg.pe_H, cfg.pe_W
    xy8 = torch.floor(project_points(K4, cam_sp) + 0.5)  # (B, S, 2)
    z = cam_sp[..., 2]
    in_view = (xy8[..., 0] >= 1) & (xy8[..., 0] <= w8 - 3) & (xy8[..., 1] >= 1) & (xy8[..., 1] <= h8 - 3) & (z > 0)
    # out-of-view projections can overflow; clamp so every derived index is
    # in range (validity rides on in_view / kpt_valid)
    xy8 = _clamp_xy(xy8, w8 - 1, h8 - 1)

    pc_kpt_idx, kpt_valid = masked_choice(noise["kpt"], in_view, cfg.num_kpt)
    pc_outline_idx, _ = masked_choice(noise["outline"], ~in_view, cfg.num_kpt)

    # coarse /8 occupancy (out-of-view superpoints go to a trash slot)
    flat8 = (xy8[..., 1] * w8 + xy8[..., 0]).long()
    flat8 = torch.where(in_view, flat8, h8 * w8)
    occupied = torch.zeros(b, h8 * w8 + 1, dtype=torch.float32, device=xy8.device).scatter_(1, flat8, 1.0)
    img_mask = occupied[:, : h8 * w8]

    coarse_xy = _take(xy8, pc_kpt_idx)  # (B, K, 2) as (x, y)
    coarse_img_kpt_idx = (coarse_xy[..., 1] * w8 + coarse_xy[..., 0]).long()
    img_outline_index, _ = masked_choice(noise["img_outline"], img_mask < 0.5, cfg.num_kpt)

    # fine /2 supervision for the selected keypoints
    uv2 = project_points(K2, _take(cam_sp, pc_kpt_idx))
    fine_xy = _clamp_xy(torch.floor(uv2), cfg.img_W // 2 - 1, cfg.img_H // 2 - 1)
    fine_center = coarse_xy * 4.0
    rel = fine_xy - fine_center + 2.0
    relative_index = torch.clamp((rel[..., 1] * 4 + rel[..., 0]).long(), 0, 15)
    fine_pc_inline_index = point2node(points[1], _take(superpoints, pc_kpt_idx))
    return {
        "K_4": K4,
        "pc_kpt_idx": pc_kpt_idx,
        "kpt_valid": kpt_valid,
        "pc_outline_idx": pc_outline_idx,
        "coarse_img_mask": img_mask.reshape(b, h8, w8),
        "coarse_img_kpt_idx": coarse_img_kpt_idx,
        "coarse_img_outline_index": img_outline_index,
        "fine_xy_coors": fine_xy.long(),
        "fine_center_kpt_coors": fine_center.long(),
        "relative_index": relative_index,
        "fine_pc_inline_index": fine_pc_inline_index,
    }


def prepare_samples(pc, attrs, P, K, img, cfg: Config, perms: Sequence[torch.Tensor], has_normals: bool = True,
                    keypoint_noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """pc (B, N, 3) camera-frame clouds, attrs (B, N, A) [intensity,
    normals] (or [intensity] without normals), P (B, 4, 4) perturbations,
    K (B, 3, 3) half-res intrinsics, img (B, H, W, 3); ``perms`` the
    per-level subsampling draws (ops/pyramid.py); ``keypoint_noise`` the
    Gumbel noise of the three keypoint draws, {'kpt': (B, S), 'outline':
    (B, S), 'img_outline': (B, H/8 * W/8)}, or None for the eval fields
    only.  Returns the model's (and the losses') batch dict.  A singular P
    raises on the CPU; on the card its frame's "P" is non-finite."""
    pc_w = apply_se3(P, pc)
    if has_normals:
        n_w = torch.einsum("bij,bnj->bni", P[:, :3, :3], attrs[..., 1:4])
        feats = torch.cat([attrs[..., :1], n_w], dim=-1)
    else:
        feats = torch.cat([attrs[..., :1], pc_w], dim=-1)
    pyr = build_pyramid(pc_w, perms, cfg.pyramid_sizes, ordering=cfg.pyramid_ordering,
                        need_maps=cfg.kpconv_impl not in ("banded", "banded_knn"), neighbor_num=cfg.neighbor_num)
    feats = torch.gather(feats, 1, pyr["perm0"][..., None].expand(-1, -1, feats.shape[-1]))
    K2 = K * 0.5
    K2[:, 2, 2] = 1.0
    # inv_ex: linalg.inv's check for a singular P would wait for the card,
    # so there a singular P gives a non-finite "P"; on the CPU it raises
    P_inv, info = torch.linalg.inv_ex(P)
    if not P.is_cuda and bool(info.any()):
        raise torch.linalg.LinAlgError(f"prepare_samples: P of frames {info.nonzero()[:, 0].tolist()} is singular")
    out = {
        "points": pyr["points"],
        "feats": feats,
        "P": P_inv,
        "K": K2,
        "img": img,
    }
    for key in ("neighbors", "subsampling", "upsampling"):
        if key in pyr:
            out[key] = pyr[key]
    if keypoint_noise is not None:
        out.update(_supervision(cfg, P, K, pyr["points"], keypoint_noise))
    return out
