"""Training losses: coarse circle loss, overlap BCE, fine circle loss
(counterpart of cofii2p_tpu/losses.py).

Batched over leading axes; every mask is a float mask over static shapes.
Each ``stop_gradient`` of the JAX package is a ``.detach()`` here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without F.softplus's linear cut-off above 20 (jax.nn.softplus)
    return torch.logaddexp(x, torch.zeros_like(x))


def desc_loss(img_features, pc_features, mask, pos_margin: float = 0.1, neg_margin: float = 1.4,
              log_scale: float = 10.0):
    """Weighted circle loss on the coarse K x K match matrix (losses.py:14-54).

    img_features, pc_features (..., C, K) channel-normalised keypoint
    features, mask (..., K, K) float correspondence mask.  Returns (loss
    (...) averaged over the K rows, cosine distances (..., K, K)), as the
    JAX function returns under ``vmap``.
    """
    pos_mask = mask
    neg_mask = 1.0 - mask
    dists = 1.0 - torch.einsum("...ck,...cl->...kl", img_features.float(), pc_features.float())

    pos = dists - 1e5 * neg_mask
    pos_weight = torch.clamp(pos - pos_margin, min=0.0).detach()
    lse_pos_row = torch.logsumexp(log_scale * (pos - pos_margin) * pos_weight, dim=-1)
    lse_pos_col = torch.logsumexp(log_scale * (pos - pos_margin) * pos_weight, dim=-2)

    neg = dists + 1e5 * pos_mask
    neg_weight = torch.clamp(neg_margin - neg, min=0.0).detach()
    lse_neg_row = torch.logsumexp(log_scale * (neg_margin - neg) * neg_weight, dim=-1)
    lse_neg_col = torch.logsumexp(log_scale * (neg_margin - neg) * neg_weight, dim=-2)

    loss_col = _softplus(lse_pos_row + lse_neg_row) / log_scale
    loss_row = _softplus(lse_pos_col + lse_neg_col) / log_scale
    return (loss_col + loss_row).mean(dim=-1), dists


def overlap_loss(inline_score, outline_score):
    """BCE pushing in-view superpoint scores to 1 and out-of-view ones to 0
    (losses.py:57-63)."""
    eps = 1e-7
    pos = -torch.log(torch.clamp(inline_score, eps, 1.0))
    neg = -torch.log(torch.clamp(1.0 - outline_score, eps, 1.0))
    return (pos.sum() + neg.sum()) / (inline_score.numel() + outline_score.numel())


def fine_circle_loss(fine_img_patch, fine_pc_feature, relative_index, m: float = 0.2, gamma: float = 5.0):
    """Circle loss over the 16 cells of each fine patch, one-hot true cell
    (losses.py:66-108).  fine_img_patch (..., K, 4, 4, C), fine_pc_feature
    (..., K, C), relative_index (..., K) in 0..15."""
    cells = fine_img_patch.reshape(*fine_img_patch.shape[:-3], 16, -1)

    def _norm(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)

    cos = torch.einsum("...kpc,...kc->...kp", _norm(cells).float(), _norm(fine_pc_feature).float())
    pos = F.one_hot(relative_index.long(), 16).to(cos.dtype)
    neg = 1.0 - pos
    sp = cos * pos
    sn = cos * neg
    ap = torch.clamp(-sp.detach() + pos + pos * m, min=0.0)
    an = torch.clamp(sn.detach() + neg * m, min=0.0)
    delta_p = 1.0 - m
    delta_n = m
    logit_p = -ap * (sp - pos * delta_p) * gamma
    logit_n = an * (sn - neg * delta_n) * gamma
    loss_p = (torch.exp(logit_p) * pos).sum(-1)
    loss_n = (torch.exp(logit_n) * neg).sum(-1)
    return torch.log(1.0 + loss_n * loss_p).mean()
