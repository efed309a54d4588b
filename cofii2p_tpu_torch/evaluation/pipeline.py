"""The inference pipeline: sample prep -> network (test mode) -> fine
matching -> EPnP-RANSAC, batched over frames (counterpart of
cofii2p_tpu/evaluation/pipeline.py).

Random draws are inputs: the pyramid's per-level subsampling and the
RANSAC hypothesis noise come either from ``draws`` (the parity tests pass
JAX's own draws) or from a ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
from cofii2p_tpu_torch.models.kpconv import KPConv
from cofii2p_tpu_torch.models.network import CoFiI2P, fine_match_xy
from cofii2p_tpu_torch.ops.pyramid import random_level_perms
from cofii2p_tpu_torch.pose.ransac import gumbel_noise, ransac_pnp
from cofii2p_tpu_torch.utils.cuda_graphs import GraphSet, serving_stages
from cofii2p_tpu_torch.utils.profiling import span


class EvalOutput(NamedTuple):
    R: torch.Tensor  # (B, 3, 3) predicted rotation
    t: torch.Tensor  # (B, 3) predicted translation
    success: torch.Tensor  # (B,) bool
    num_inliers: torch.Tensor  # (B,)
    P_gt: torch.Tensor  # (B, 4, 4)
    fine_xy: torch.Tensor  # (B, S, 2) predicted pixels (/2 scale)
    corr_mask: torch.Tensor  # (B, S) correspondence validity
    object_points: torch.Tensor  # (B, S, 3)
    pc_score: torch.Tensor  # (B, S)


def make_draws(cfg: Config, batch: int, generator: torch.Generator, device) -> dict:
    """The pipeline's random inputs drawn from ``generator``."""
    return {
        "perms": random_level_perms(batch, cfg.pyramid_sizes, generator, device),
        "gumbel": gumbel_noise((batch, cfg.ransac_hypotheses, cfg.num_superpoints), generator, device),
    }


def make_eval_body(cfg: Config, model: CoFiI2P, has_normals: bool = True, stages: Optional[Sequence[str]] = None):
    """Returns run(host_batch, generator=None, draws=None) -> EvalOutput.

    host_batch holds tensors on the model's device: pc (B, N, 3), attrs
    (B, N, A), P (B, 4, 4), K (B, 3, 3), img (B, H, W, 3).

    On the card the ``stages`` (utils/cuda_graphs.py::STAGES; by default
    ``serving_stages(cfg)``, all of them but the gather k-NN's prep) replay
    as CUDA graphs, one set a batch shape, captured on its first call:
    prep inside ``cofii2p.prep``, the point branch inside
    ``model.pc_encoder``'s forward (each KPConv's part inside that KPConv's
    call), the rest of the network inside ``model``'s, fine matching and
    RANSAC after it; ``stages=()`` gives the eager body.  The inputs are
    copied into the graphs' buffers, and the returned fields are copies of
    theirs.  Outside ``run`` the model is left as it was.
    """

    ransac = functools.partial(
        ransac_pnp, inlier_threshold=cfg.ransac_inlier_px, refine_iters=cfg.ransac_refine_iters
    )
    graphs = GraphSet(serving_stages(cfg) if stages is None else stages)
    eager = GraphSet(())
    kpconvs = [m for m in model.pc_encoder.modules() if isinstance(m, KPConv)]

    def prep(pc, attrs, P, K, img, perms):
        return prepare_samples(pc, attrs, P, K, img, cfg, perms, has_normals=has_normals)

    def match(fine_img_patch, fine_pc_feature, fine_center_xy, inlier_mask):
        """Fine matching, and the correspondence mask as RANSAC takes it."""
        fine_xy = fine_match_xy(fine_img_patch, fine_pc_feature, fine_center_xy, decode=cfg.fine_decode)
        return fine_xy, inlier_mask.float()

    @torch.no_grad()
    def run(host_batch, generator: Optional[torch.Generator] = None, draws: Optional[dict] = None):
        pc = host_batch["pc"]
        on = graphs if pc.is_cuda else eager
        with (span("cofii2p.eval"), on.bound(model.pc_encoder, "forward", "pc_encoder", kpconvs),
              on.bound(model, "heads", "network")):
            if draws is None:
                draws = make_draws(cfg, pc.shape[0], generator, pc.device)
            with span("cofii2p.prep"):
                batch = on.stage("prep", prep)(
                    pc, host_batch["attrs"], host_batch["P"], host_batch["K"], host_batch["img"], draws["perms"]
                )
            out = model(batch, mode="test")
            with span("cofii2p.fine_match"):
                fine_xy, mask = on.stage("fine_match", match)(
                    out["fine_img_patch"], out["fine_pc_feature"], out["fine_center_xy"], out["inlier_mask"]
                )
            res = on.stage("ransac", ransac)(draws["gumbel"], out["coarse_pc_points"], fine_xy, batch["K"], mask)
            fields = {"R": res.R, "t": res.t, "success": res.success, "num_inliers": res.num_inliers,
                      "P_gt": batch["P"], "fine_xy": fine_xy, "corr_mask": out["inlier_mask"],
                      "object_points": out["coarse_pc_points"], "pc_score": out["coarse_pc_score"]}
            if on.names:  # the graphs' buffers: the next request writes them
                fields = {k: v.clone() for k, v in fields.items()}
            return EvalOutput(**fields)

    return run


def pose_errors_np(T_pred, P_gt):
    """Reference error metric (cofii2p_tpu/evaluation/pipeline.py:98-108):
    P_diff = inv(T_pred) @ P_gt, RTE = |t_diff|, RRE = sum |euler('xzy')|
    in degrees.  numpy (4, 4) float64 inputs."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    P_diff = np.linalg.inv(T_pred) @ P_gt
    t_diff = np.linalg.norm(P_diff[:3, 3])
    angles = np.sum(np.abs(Rotation.from_matrix(P_diff[:3, :3]).as_euler("xzy", degrees=True)))
    return t_diff, angles
