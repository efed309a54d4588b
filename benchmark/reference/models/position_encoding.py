"""Sine positional encoding (counterpart of
cofii2p_tpu/models/position_encoding.py)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def position_embedding_sine(coords: torch.Tensor, d_model: int, temperature: float = 10000.0) -> torch.Tensor:
    """coords (..., n_dim) -> (..., d_model): per input dim an interleaved
    sin/cos frequency ladder, remainder channels zero-padded."""
    n_dim = coords.shape[-1]
    num_feats = d_model // n_dim // 2 * 2
    padding = d_model - num_feats * n_dim
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=coords.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    x = coords.float() * (2.0 * math.pi)
    divided = x[..., None] / dim_t  # (..., n_dim, num_feats)
    emb = torch.stack([torch.sin(divided[..., 0::2]), torch.cos(divided[..., 1::2])], dim=-1)
    emb = emb.reshape(*coords.shape[:-1], -1)
    return F.pad(emb, (0, padding)) if padding else emb


def image_grid_coords(h: int, w: int, device=None) -> torch.Tensor:
    """(h*w, 2) (row, col) grid in row-major token order."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([ys, xs], dim=-1).reshape(h * w, 2)
