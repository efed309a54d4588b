"""The training step in plain PyTorch, fp32: sample prep with the
supervision, the forward in train mode, the three losses of the
reference's train.py, the backward under plain autograd and Adam with
optax's defaults.  Each banded KPConv and shortcut maxpool is
checkpointed (ops/plain.py), so that a batch of 8 fits the card."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import losses
from benchmark.reference.config import Config
from benchmark.reference.data.device_pipeline import prepare_samples
from benchmark.reference.models.network import CoFiI2P


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam at ``cfg.lr``, b1 0.9, b2 0.999, eps 1e-8 (optax's adam)."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def prepare_batch(cfg: Config, host_batch: dict, draws: dict, has_normals: bool = True) -> dict:
    return prepare_samples(
        host_batch["pc"], host_batch["attrs"], host_batch["P"], host_batch["K"], host_batch["img"],
        cfg, draws["perms"], has_normals=has_normals, keypoint_noise=draws["keypoint_noise"],
    )


def batch_losses(cfg: Config, out: dict, batch: dict) -> Dict[str, torch.Tensor]:
    """The three losses of the reference's train.py:224-283, batched
    (train_lib.py:60-116)."""
    h8, w8 = cfg.pe_H, cfg.pe_W
    pc_feat = out["pc_feature_norm"]  # (B, S, C)
    img_feat = out["img_feature_norm"].reshape(pc_feat.shape[0], h8 * w8, -1)
    kpt, outl = batch["pc_kpt_idx"], batch["pc_outline_idx"]
    img_kpt = batch["coarse_img_kpt_idx"]

    def take(x, i):
        return torch.gather(x, 1, i[..., None].expand(-1, -1, x.shape[-1]))

    pc_inline = take(pc_feat, kpt)  # (B, K, C)
    img_inline = take(img_feat, img_kpt)

    # GT correspondence mask: project the selected superpoints with the GT
    # pose and compare with the image keypoints' grid cells
    pc_xyz = take(batch["points"][-1], kpt)
    P = batch["P"]
    cam = torch.einsum("bij,bkj->bki", P[:, :3, :3], pc_xyz) + P[:, None, :3, 3]
    uvw = torch.einsum("bij,bkj->bki", batch["K_4"], cam)
    uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-12)
    img_xy = torch.stack([(img_kpt % w8).float(), torch.div(img_kpt, w8, rounding_mode="floor").float()], -1)
    d = torch.linalg.vector_norm(img_xy[:, :, None, :] - uv[:, None, :, :], dim=-1)
    corr_mask = (d <= cfg.dist_thres).float()  # (B, K, K)
    valid = batch["kpt_valid"].float()
    corr_mask = corr_mask * valid[:, :, None] * valid[:, None, :]

    loss_desc, dists = losses.desc_loss(
        img_inline.transpose(1, 2), pc_inline.transpose(1, 2), corr_mask,
        pos_margin=cfg.pos_margin, neg_margin=cfg.neg_margin,
    )
    loss_desc = loss_desc.mean()

    score = out["coarse_pc_score"]  # (B, S)
    loss_coarse = losses.overlap_loss(torch.gather(score, 1, kpt), torch.gather(score, 1, outl))
    loss_fine = losses.fine_circle_loss(out["fine_img_patch"], out["fine_pc_feature"], batch["relative_index"])
    return {
        "loss_desc": loss_desc,
        "loss_coarse": loss_coarse,
        "loss_fine": loss_fine,
        "loss": loss_desc + loss_coarse + loss_fine,
        "corr_mask": corr_mask,
        "dists": dists,
    }


def loss_fn(cfg: Config, model: CoFiI2P, batch: dict) -> Dict[str, torch.Tensor]:
    """Forward in ``mode='train'`` with the BatchNorms in training mode
    (their running statistics update in place), then the losses."""
    out = model(batch, mode="train", train=True)
    return batch_losses(cfg, out, batch)
