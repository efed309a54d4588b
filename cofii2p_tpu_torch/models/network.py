"""CoFiI2P network (counterpart of cofii2p_tpu/models/network.py).

Two-stream encoders (ResNet-34 image branch, KPConv FPN: banded, or the
gather formulation over the batch's k-NN maps), sine
positional encodings, the 8-layer I2P transformer, overlap score heads,
the /2 fine image map; then, in ``mode='test'``, the closed-form selection
that replaces the reference's threshold-decay loop, or, in ``'train'`` and
``'val'``, the supervised fine patches around the batch's keypoints.
Module names follow the reference state dict, so ``utils/convert.py`` and
a reference ``.t7`` load into it by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cofii2p_tpu_torch.config import Config
from cofii2p_tpu_torch.models.kpconv import KPConvFPN
from cofii2p_tpu_torch.models.layers import LayerNorm, Linear, instance_norm
from cofii2p_tpu_torch.models.position_encoding import image_grid_coords, position_embedding_sine
from cofii2p_tpu_torch.models.resnet import ImageUpSample, ResNetEncoder
from cofii2p_tpu_torch.models.transformer import LocalFeatureTransformer
from cofii2p_tpu_torch.ops.geometry import point2node
from cofii2p_tpu_torch.ops.patch import extract_patches
from cofii2p_tpu_torch.utils.profiling import span


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    return x32 / torch.clamp(torch.linalg.vector_norm(x32, dim=dim, keepdim=True), min=eps)


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class PCFeatureHead(nn.Sequential):
    """2048 -> 1024 -> 512 -> 128 projection (reference network.py:29)."""

    def __init__(self, dtype=torch.float32):
        super().__init__(
            Linear(2048, 1024, bias=False, dtype=dtype), LayerNorm(1024), nn.ReLU(),
            Linear(1024, 512, bias=False, dtype=dtype), LayerNorm(512), nn.ReLU(),
            Linear(512, 128, bias=False, dtype=dtype),
        )


class Conv1x1(nn.Module):
    """A 1x1 convolution applied channels-last: weight (O, I, 1) or
    (O, I, 1, 1) as the reference's Conv1d/Conv2d stores it."""

    def __init__(self, cin, cout, rank, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * (rank - 2)))
        nn.init.kaiming_uniform_(self.weight.view(cout, cin), a=5**0.5)
        self.dtype = dtype

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(x.to(self.dtype), w.to(self.dtype))


class _InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x, tuple(range(1, x.ndim - 1)))


class ScoreHead(nn.Sequential):
    """1x1-conv overlap score head with parameter-free instance norms
    (reference network.py:42-43); (B, N, C) or (B, H, W, C) -> (..., 1)
    fp32 in (0, 1)."""

    def __init__(self, cin=128, rank=3, dtype=torch.float32):
        super().__init__(
            Conv1x1(cin, 128, rank, dtype), _InstanceNorm(), nn.ReLU(),
            Conv1x1(128, 64, rank, dtype), _InstanceNorm(), nn.ReLU(),
            Conv1x1(64, 1, rank, dtype), nn.Sigmoid(),
        )

    def forward(self, x):
        for i, mod in enumerate(self):
            x = mod(x.float() if i == 7 else x)
        return x


class CoFiI2P(nn.Module):
    """forward(batch, mode='test', train=False) on a batch prepared by
    data/device_pipeline.py::prepare_samples; ``train`` puts the decoder
    BatchNorms in training mode (batch statistics, running update)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.pc_encoder = KPConvFPN(
            input_dim=cfg.kpconv_input_dim, output_dim=cfg.kpconv_output_dim,
            init_dim=cfg.kpconv_init_dim, kernel_size=cfg.kernel_size,
            init_radius=cfg.init_radius, init_sigma=cfg.init_sigma, group_norm=cfg.group_norm,
            dtype=dtype, tile=cfg.kpconv_tile, band_width=cfg.kpconv_band_width,
            band_plan=cfg.kpconv_band_plan, kernel=cfg.kpconv_kernel,
            dynamic_plan=cfg.kpconv_dynamic_plan, dynamic_plan_self=cfg.kpconv_dynamic_plan_self,
            dynamic_center=cfg.kpconv_dynamic_center, impl=cfg.kpconv_impl, knn_k=cfg.neighbor_num,
            knn_window_plan=cfg.kpconv_knn_window_plan, shared_influence=cfg.kpconv_shared_influence,
            residual_fused=cfg.kpconv_residual_fused, norm=cfg.norm,
            maxpool_compact_plan=cfg.maxpool_compact_plan, aggregate_compact_plan=cfg.aggregate_compact_plan,
        )
        stage_sizes = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}[cfg.img_backbone]
        self.img_encoder = ResNetEncoder(stage_sizes, dtype=dtype)
        self.pc_feature_layer = PCFeatureHead(dtype)
        self.transformer = LocalFeatureTransformer(
            cfg.d_model, cfg.nhead, ("self", "cross") * cfg.num_transformer_layers, dtype, cfg.attention
        )
        self.pc_score_layer = ScoreHead(cfg.d_model, 3, dtype)
        self.img_score_layer = ScoreHead(cfg.d_model, 4, dtype)
        self.img_upsample_1 = ImageUpSample(128 + 64, 128, dtype)
        self.img_upsample_2 = ImageUpSample(128 + 64, 64, dtype)
        self.dtype = dtype

    def forward(self, batch, mode: str = "test", train: bool = False):
        with span("cofii2p.network"):
            with span("cofii2p.pc_encoder"):
                pc_feature_set = self.pc_encoder(batch["feats"], batch["points"], batch.get("neighbors"),
                                                 batch.get("subsampling"), batch.get("upsampling"))
            return self.heads(batch, pc_feature_set, mode, train)

    def heads(self, batch, pc_feature_set, mode: str = "test", train: bool = False):
        """The network after the point branch: the image branch, the
        transformer, the score heads and the fine map, then the test-mode
        selection or the supervised fine patches.  A serving body on the
        card replays it as a CUDA graph (evaluation/pipeline.py)."""
        cfg, dtype = self.cfg, self.dtype
        img, points = batch["img"], batch["points"]
        b = img.shape[0]
        h8, w8 = cfg.pe_H, cfg.pe_W
        with span("cofii2p.img_encoder"):
            img_feature_set = self.img_encoder(img)

        pc_fine = l2norm(pc_feature_set[0])
        pc_feature_middle = l2norm(self.pc_feature_layer(pc_feature_set[-1]))
        img_s2, img_s4 = img_feature_set[0], img_feature_set[1]
        img_s8 = l2norm(img_feature_set[2])

        img_pos = position_embedding_sine(image_grid_coords(h8, w8, img.device), cfg.d_model)
        pc_pos = position_embedding_sine(points[-1], cfg.d_model)
        img_tokens = img_s8.reshape(b, h8 * w8, cfg.d_model) + img_pos[None]
        pc_tokens = pc_feature_middle + pc_pos
        img_mid, pc_fused = self.transformer(img_tokens.to(dtype), pc_tokens.to(dtype))
        img_mid_map = img_mid.reshape(b, h8, w8, cfg.d_model)

        coarse_pc_score = self.pc_score_layer(pc_fused)[..., 0]
        coarse_img_score = self.img_score_layer(img_mid_map)[..., 0]
        pc_feature_norm = l2norm(pc_fused)
        img_feature_norm = l2norm(img_mid_map)

        # the reference upsamples the l2-normalised /8 map (network.py:91,129)
        up4 = self.img_upsample_1(img_s8.to(dtype), img_s4, train)
        up2 = l2norm(self.img_upsample_2(up4, img_s2, train))

        out = {
            "img_feature_norm": img_feature_norm,
            "pc_feature_norm": pc_feature_norm,
            "coarse_img_score": coarse_img_score,
            "coarse_pc_score": coarse_pc_score,
            "fine_img_map": up2,
            "pc_fused": pc_fused,
            "img_mid": img_mid,
            "pc_features": pc_feature_set,
        }
        if mode in ("train", "val"):
            # supervised fine patches around the projected keypoints (network.py:192-202)
            idx = batch["fine_pc_inline_index"].long()
            out["fine_pc_feature"] = torch.gather(pc_fine, 1, idx[..., None].expand(-1, -1, pc_fine.shape[-1]))
            out["fine_img_patch"] = extract_patches(up2, batch["fine_center_kpt_coors"], 4)
        elif mode == "test":
            with span("cofii2p.selection"):
                out.update(self._test_mode(cfg, points, coarse_pc_score, pc_feature_norm, img_feature_norm,
                                           pc_fine, up2))
        else:
            raise KeyError(mode)
        return out

    @staticmethod
    def _test_mode(cfg, points, pc_score, pc_feat, img_feat, pc_fine, fine_img_map):
        """Closed-form threshold-decay selection (network.py:214-269)."""
        b = pc_score.shape[0]
        h8, w8 = cfg.pe_H, cfg.pe_W
        img_flat = img_feat.reshape(b, h8 * w8, cfg.d_model)
        sim = torch.einsum("blc,bsc->bls", img_flat.float(), pc_feat.float())
        best_img = torch.argmax(sim, dim=1)  # (B, S), first maximum
        cx = (best_img % w8).float()
        cy = torch.div(best_img, w8, rounding_mode="floor").float()
        border_ok = (cx >= 2) & (cx <= w8 - 2) & (cy >= 2) & (cy <= h8 - 2)

        ks = torch.arange(cfg.test_score_thresholds_num, dtype=torch.float32, device=pc_score.device)
        thrs = cfg.test_score_thresholds_start - cfg.test_score_thresholds_step * ks
        counts = ((pc_score[:, None, :] >= thrs[None, :, None]) & border_ok[:, None, :]).sum(-1)
        enough = counts >= 4
        sel = torch.where(
            enough.any(-1), torch.argmax(enough.to(torch.int32), dim=-1),
            torch.full_like(counts[:, 0], len(ks) - 1),
        )
        t_star = thrs[sel]
        inlier_mask = (pc_score >= t_star[:, None]) & border_ok

        fine_center_xy = torch.stack([cx, cy], dim=-1) * 4.0
        patches = extract_patches(fine_img_map, fine_center_xy, 4)
        idx_lvl1 = point2node(points[1], points[-1])
        fine_pc_feature = torch.gather(pc_fine, 1, idx_lvl1[..., None].expand(-1, -1, pc_fine.shape[-1]))
        return {
            "inlier_mask": inlier_mask,
            "threshold": t_star,
            "fine_center_xy": fine_center_xy,
            "fine_img_patch": patches,
            "fine_pc_feature": fine_pc_feature,
            "coarse_pc_points": points[-1],
        }


def fine_match_xy(fine_img_patch, fine_pc_feature, fine_center_xy, decode: str = "label"):
    """Argmax fine matching inside each 4x4 patch -> (B, S, 2) pixels on the
    /2 image (network.py:272-310); ``decode='reference'`` keeps the
    reference eval's swapped axes."""
    b, s = fine_pc_feature.shape[:2]
    cells_n = l2norm(fine_img_patch.reshape(b, s, 16, -1))
    pc_n = l2norm(fine_pc_feature)
    idx = torch.argmax(torch.einsum("bspc,bsc->bsp", cells_n, pc_n), dim=-1)
    if decode == "reference":
        dx, dy = torch.div(idx, 4, rounding_mode="floor"), idx % 4
    elif decode == "label":
        dx, dy = idx % 4, torch.div(idx, 4, rounding_mode="floor")
    else:
        raise ValueError(f"decode {decode!r} is not 'label' or 'reference'")
    return fine_center_xy - 2.0 + torch.stack([dx, dy], dim=-1).float()
