"""Fine-patch extraction (counterpart of cofii2p_tpu/ops/patch.py)."""

from __future__ import annotations

import torch


def extract_patches(feature_map: torch.Tensor, centers_xy: torch.Tensor, size: int = 4) -> torch.Tensor:
    """size x size patches around pixel centers, batched.

    feature_map (B, H, W, C), centers_xy (B, N, 2) as (x, y); the patch
    rows/cols are floor(center - size/2) ... + size - 1, clamped to the
    border.  Returns (B, N, size, size, C).
    """
    b, h, w, _ = feature_map.shape
    top_left = torch.floor(centers_xy.float() - size / 2).long()
    offs = torch.arange(size, device=feature_map.device)
    cols = torch.clamp(top_left[..., 0, None] + offs, 0, w - 1)  # (B, N, size)
    rows = torch.clamp(top_left[..., 1, None] + offs, 0, h - 1)
    bi = torch.arange(b, device=feature_map.device)[:, None, None, None]
    return feature_map[bi, rows[..., :, None], cols[..., None, :]]
