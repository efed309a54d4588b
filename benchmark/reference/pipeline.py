"""The serving path in plain PyTorch, fp32: sample prep, the test-mode
network, the fine match and EPnP-RANSAC, run one stage after the other
with no captured graph and no kernel of the port."""

from __future__ import annotations

import functools

import torch

from benchmark.reference.data.device_pipeline import prepare_samples
from benchmark.reference.models.network import fine_match_xy
from benchmark.reference.pose.ransac import ransac_pnp


def solver(cfg):
    return functools.partial(ransac_pnp, inlier_threshold=cfg.ransac_inlier_px, refine_iters=cfg.ransac_refine_iters)


@torch.no_grad()
def serve(cfg, model, host_batch: dict, draws: dict) -> dict:
    """What the served path answers for one request, and the prepared
    intrinsics the pose solver used."""
    batch = prepare_samples(host_batch["pc"], host_batch["attrs"], host_batch["P"], host_batch["K"],
                            host_batch["img"], cfg, draws["perms"])
    out = model(batch, mode="test")
    fine_xy = fine_match_xy(out["fine_img_patch"], out["fine_pc_feature"], out["fine_center_xy"],
                            decode=cfg.fine_decode)
    res = solver(cfg)(draws["gumbel"], out["coarse_pc_points"], fine_xy, batch["K"], out["inlier_mask"].float())
    return dict(R=res.R, t=res.t, success=res.success, num_inliers=res.num_inliers, P_gt=batch["P"],
                fine_xy=fine_xy, corr_mask=out["inlier_mask"], object_points=out["coarse_pc_points"],
                pc_score=out["coarse_pc_score"].float(), K=batch["K"])


@torch.no_grad()
def pose(cfg, gumbel, object_points, fine_xy, K, corr_mask) -> dict:
    """The pose solver alone on given correspondences."""
    res = solver(cfg)(gumbel, object_points, fine_xy, K, corr_mask.float())
    return dict(R=res.R, t=res.t, success=res.success, num_inliers=res.num_inliers)
