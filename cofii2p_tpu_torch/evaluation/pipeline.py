"""The inference pipeline: sample prep -> network (test mode) -> fine
matching -> EPnP-RANSAC, batched over frames (counterpart of
cofii2p_tpu/evaluation/pipeline.py).

Random draws are inputs: the pyramid's per-level subsampling and the
RANSAC hypothesis noise come either from ``draws`` (the parity tests pass
JAX's own draws) or from a ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
from cofii2p_tpu_torch.models.network import CoFiI2P, fine_match_xy
from cofii2p_tpu_torch.ops.cuda_lib import graph_nodes
from cofii2p_tpu_torch.ops.pyramid import random_level_perms
from cofii2p_tpu_torch.pose.ransac import gumbel_noise, ransac_pnp
from cofii2p_tpu_torch.utils.profiling import counter, span


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


class CudaGraphed:
    """Replays ``fn`` as one captured CUDA graph per input signature.

    For the RANSAC stage: it is thousands of tiny elementwise kernels on
    (B, hypotheses, ...) tensors, static in shape and free of host syncs,
    so launched one by one the host, not the card, sets its pace.
    ``fn`` takes tensors and returns a NamedTuple of tensors; each call
    copies the inputs into the graph's static buffers and returns copies
    of its outputs.
    """

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}

    def __call__(self, *args):
        with span("cofii2p.ransac"):
            key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
            if key not in self.graphs:
                self.graphs[key] = self._capture(args)
            graph, static_in, static_out = self.graphs[key]
            for dst, src in zip(static_in, args):
                dst.copy_(src)
            with span("cofii2p.ransac.replay"):
                graph.replay()
            return type(static_out)(*(t.clone() for t in static_out))

    def _capture(self, args):
        static_in = [a.clone() for a in args]
        side = torch.cuda.Stream(args[0].device)
        side.wait_stream(torch.cuda.current_stream(args[0].device))
        with torch.cuda.stream(side):
            self.fn(*static_in)  # warm-up outside the capture
        torch.cuda.current_stream(args[0].device).wait_stream(side)
        # keep_graph: the captured graph stays readable for its node count,
        # and is instantiated after
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            static_out = self.fn(*static_in)
        count_nodes(graph)
        graph.instantiate()
        return graph, static_in, static_out


def count_nodes(graph) -> None:
    """Adds a captured graph's nodes to ``cofii2p.ransac.graph_nodes`` and
    one to ``cofii2p.ransac.captures``, so that their ratio is a graph's
    nodes whatever shapes were captured.  The count is a diagnostic: where
    the driver cannot give it, the graph serves uncounted and the counters
    stay as they were."""
    try:
        n = graph_nodes(graph)
    except Exception:  # a missing or refusing driver entry point
        return
    counter("cofii2p.ransac.graph_nodes").add(n)
    counter("cofii2p.ransac.captures").add()


def make_eval_body(cfg: Config, model: CoFiI2P, has_normals: bool = True):
    """Returns run(host_batch, generator=None, draws=None) -> EvalOutput.

    host_batch holds tensors on the model's device: pc (B, N, 3), attrs
    (B, N, A), P (B, 4, 4), K (B, 3, 3), img (B, H, W, 3).
    """

    ransac = functools.partial(
        ransac_pnp, inlier_threshold=cfg.ransac_inlier_px, refine_iters=cfg.ransac_refine_iters
    )
    ransac_graphed = CudaGraphed(ransac)

    @torch.no_grad()
    def run(host_batch, generator: Optional[torch.Generator] = None, draws: Optional[dict] = None):
        with span("cofii2p.eval"):
            b = host_batch["pc"].shape[0]
            if draws is None:
                draws = make_draws(cfg, b, generator, host_batch["pc"].device)
            with span("cofii2p.prep"):
                batch = prepare_samples(
                    host_batch["pc"], host_batch["attrs"], host_batch["P"], host_batch["K"],
                    host_batch["img"], cfg, draws["perms"], has_normals=has_normals,
                )
            out = model(batch, mode="test")
            with span("cofii2p.fine_match"):
                fine_xy = fine_match_xy(
                    out["fine_img_patch"], out["fine_pc_feature"], out["fine_center_xy"], decode=cfg.fine_decode
                )
            solve = ransac_graphed if fine_xy.is_cuda else ransac
            res = solve(draws["gumbel"], out["coarse_pc_points"], fine_xy, batch["K"], out["inlier_mask"].float())
            return EvalOutput(
                R=res.R, t=res.t, success=res.success, num_inliers=res.num_inliers, P_gt=batch["P"],
                fine_xy=fine_xy, corr_mask=out["inlier_mask"], object_points=out["coarse_pc_points"],
                pc_score=out["coarse_pc_score"],
            )

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
