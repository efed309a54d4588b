"""Training step construction: loss wiring, optimizer, top-k validation
(counterpart of cofii2p_tpu/train_lib.py).

One step is on-device sample prep (pyramid and supervision), the forward in
``mode='train'``, the three losses, the backward through the port's
kernels, and the Adam update.  The model holds the parameters and the
BatchNorm running statistics (the JAX ``batch_stats``), the optimizer its
moments; the random draws of a step are inputs (:func:`make_train_draws`).

Data parallelism (``mesh`` from parallel/mesh.py::make_mesh, one process a
card under ``torchrun``): each rank holds a replica of the parameters and
its rows of the global batch and of the global step's draws.  A step then
equals the one-process step on the global batch, as XLA's partitioning of
the JAX step does: the gradient is averaged over the group; the decoder's
BatchNorms normalise with the global batch's statistics
(models/resnet.py::BatchNorm2d); and each loss is a mean over units every
rank holds equally many of (desc_loss over frames, overlap_loss over
keypoints, fine_circle_loss over (frame, keypoint); losses.py:54, 63,
108), so the mean of the ranks' losses is the global loss and the mean of
their gradients its gradient.  Metrics are reduced the same way; the
validation recalls sum their numerators and denominators over the group.
"""

from __future__ import annotations

from typing import Dict

import torch

from cofii2p_tpu_torch import losses
from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.data.device_pipeline import KEYPOINT_NOISE, prepare_samples
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.ops.pyramid import random_level_perms
from cofii2p_tpu_torch.parallel.mesh import all_reduce_sum_, shard_tree, sync_batch_norms
from cofii2p_tpu_torch.pose.ransac import gumbel_noise
from cofii2p_tpu_torch.utils.profiling import span

METRICS = ("loss", "loss_desc", "loss_coarse", "loss_fine")


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam at ``cfg.lr`` with optax ``adam``'s defaults (b1 0.9, b2 0.999,
    eps 1e-8, eps_root 0), the same update; the epoch-level decay sets the
    rate through :func:`set_learning_rate` (train_lib.py:32-57)."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    lr = cfg.lr * (cfg.lr_decay_step ** (epoch // 5))
    return max(lr, cfg.min_lr)


def resume_epoch(cfg: Config, global_step: int, steps_per_epoch: int) -> int:
    """Epoch a restored run continues from, derived from its step, so a
    resumed run stays on the LR-decay schedule."""
    return min(global_step // max(steps_per_epoch, 1), cfg.epoch)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_train_draws(cfg: Config, batch: int, generator: torch.Generator, device, mesh=None) -> dict:
    """The random inputs of one train (or eval) step of global batch
    ``batch`` drawn from ``generator``: the pyramid permutations and the
    Gumbel noise of the three keypoint draws; with ``mesh``, this rank's
    rows of them, so that the draws do not change with the world size."""
    s, l = cfg.num_superpoints, cfg.num_img_tokens
    shapes = {"kpt": (batch, s), "outline": (batch, s), "img_outline": (batch, l)}
    draws = {
        "perms": random_level_perms(batch, cfg.pyramid_sizes, generator, device),
        "keypoint_noise": {k: gumbel_noise(shapes[k], generator, device) for k in KEYPOINT_NOISE},
    }
    return draws if mesh is None else shard_tree(draws, batch, mesh)


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
    with span("cofii2p.train.losses"):
        return batch_losses(cfg, out, batch)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _mean_over(values: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each 0-d value averaged over the mesh's ranks."""
    if mesh is None or mesh.get_group() is None:
        return values
    stacked = torch.stack([v.float() for v in values.values()])
    all_reduce_sum_([stacked], mesh)
    return dict(zip(values, stacked / mesh.size()))


def make_train_step(cfg: Config, model: CoFiI2P, optimizer: torch.optim.Optimizer, has_normals: bool = True,
                    mesh=None):
    """Returns train_step(host_batch, draws) -> metrics (0-d tensors on the
    model's device): one update of ``model`` and ``optimizer`` in place.
    With ``mesh``, host_batch and draws hold this rank's rows and the step
    is the global batch's (module docstring)."""
    if mesh is not None:
        sync_batch_norms(model, mesh)

    def train_step(host_batch: dict, draws: dict) -> Dict[str, torch.Tensor]:
        with span("cofii2p.train_step"):
            with torch.no_grad(), span("cofii2p.prep"):
                batch = prepare_batch(cfg, host_batch, draws, has_normals)
            optimizer.zero_grad(set_to_none=True)
            terms = loss_fn(cfg, model, batch)
            with span("cofii2p.train.backward"):
                terms["loss"].backward()
            with span("cofii2p.train.grad_norm"):
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                if mesh is not None and mesh.get_group() is not None:
                    all_reduce_sum_(grads, mesh)
                    if mesh.size() > 1:
                        for g in grads:
                            g.div_(mesh.size())
                metrics = _mean_over({k: terms[k].detach() for k in METRICS}, mesh)
                metrics["grad_norm"] = global_norm(grads).detach()
            with span("cofii2p.train.optimizer"):
                optimizer.step()
            return metrics

    return train_step


def make_eval_step(cfg: Config, model: CoFiI2P, has_normals: bool = True, mesh=None):
    """Returns eval_step(host_batch, draws) -> recalls: coarse top-k
    matching recall, fine recall and the loss on a validation batch, with
    the running BatchNorm statistics (train_lib.py:165-224); with ``mesh``,
    of the global batch whose rows this rank holds."""

    @torch.no_grad()
    def eval_step(host_batch: dict, draws: dict) -> Dict[str, torch.Tensor]:
        batch = prepare_batch(cfg, host_batch, draws, has_normals)
        out = model(batch, mode="val", train=False)
        terms = batch_losses(cfg, out, batch)
        # a keypoint is recalled at k if one of its k nearest image
        # keypoints (by fused-feature distance) is a GT correspondence
        dists, mask = terms["dists"], terms["corr_mask"]  # (B, K, K) img x pc
        ranks = torch.argsort(dists, dim=1, stable=True)
        valid = batch["kpt_valid"].float()
        has_pos = mask.sum(dim=1) > 0
        # numerators and denominators, summed over the group before dividing
        sums = [torch.gather(mask, 1, ranks[:, :k, :]).amax(dim=1).mul(has_pos).sum() for k in (1, 2, 3, 4, 5)]
        sums.append(has_pos.sum().float())
        # fine recall: the argmax cell of each keypoint's patch is its label
        patch = out["fine_img_patch"]
        cells = patch.reshape(*patch.shape[:-3], 16, -1)

        def nrm(x):
            return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)

        cos = torch.einsum("bkpc,bkc->bkp", nrm(cells).float(), nrm(out["fine_pc_feature"]).float())
        fine_hit = (torch.argmax(cos, dim=-1) == batch["relative_index"]).float()
        sums += [(fine_hit * valid).sum(), valid.sum()]
        sums = torch.stack(sums)
        all_reduce_sum_([sums], mesh)
        recalls = {f"top{k}_recall": sums[k - 1] / torch.clamp(sums[5], min=1) for k in (1, 2, 3, 4, 5)}
        recalls["fine_recall"] = sums[6] / torch.clamp(sums[7], min=1)
        recalls.update(_mean_over({"val_loss": terms["loss"]}, mesh))
        return recalls

    return eval_step
