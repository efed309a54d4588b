"""Configuration of the plain reference: the port's ``Config`` dataclass,
field for field, so one configuration file's fields make both sides.
The reference computes only the options the benchmark's cells run;
models/network.py refuses the others (``UNPORTED``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Base config; dataset-specific configs override fields.

    All shape-determining fields are static so the whole pipeline jits.
    """

    dataset: str = "kitti"

    # paths (reference: options.py:8-11)
    data_path: str = "../corri2p_data"
    root_path: str = "."
    save_path: str = "checkpoints"
    log_path: str = "logs"

    # image geometry (reference: options.py:15-19)
    crop_original_top_rows: int = 50
    img_scale: float = 0.5
    img_H: int = 160
    img_W: int = 512
    img_fine_resolution_scale: int = 32

    # point cloud shapes (reference: options.py:21-30)
    num_pc: int = 20480
    num_kpt: int = 64
    pc_min_range: float = -1.0
    pc_max_range: float = 80.0
    node_a_num: int = 1280
    node_b_num: int = 1280

    # pyramid (reference: preprocess_data.py:38,55-69 — 5 stages, k=128, /2 per stage)
    num_stages: int = 5
    neighbor_num: int = 128

    # offline sweep accumulation (reference: options.py:12-13 KITTI / 68-69
    # nuScenes; consumed by data/build_nuscenes.py)
    accumulation_frame_num: int = 3
    accumulation_frame_skip: int = 6

    # pose perturbation amplitudes, camera frame (reference: options.py:33-38)
    P_tx_amplitude: float = 10.0
    P_ty_amplitude: float = 0.0
    P_tz_amplitude: float = 10.0
    P_Rx_amplitude: float = 0.0 * math.pi / 12.0
    P_Ry_amplitude: float = 2.0 * math.pi
    P_Rz_amplitude: float = 0.0 * math.pi / 12.0

    # loss margins / thresholds (reference: options.py:39-43)
    dist_thres: float = 1.0
    img_thres: float = 0.9
    pc_thres: float = 0.9
    pos_margin: float = 0.2
    neg_margin: float = 1.8

    # model (reference: network.py:24,33-43)
    norm: str = "gn"
    group_norm: int = 32
    d_model: int = 128
    nhead: int = 4
    num_transformer_layers: int = 4  # x ('self','cross') pairs = 8 layers
    attention: str = "full"  # 'full' | 'linear' (reference ATTENTION option)
    img_backbone: str = "resnet34"  # 'resnet34' | 'resnet18'
    kpconv_input_dim: int = 4
    kpconv_init_dim: int = 64
    kpconv_output_dim: int = 64
    kernel_size: int = 15
    init_radius: float = 4.25 * 0.1
    init_sigma: float = 2.0 * 0.1

    # KPConv neighbor aggregation (ops/banded.py):
    #  'gather'     — reference-parity kNN(neighbor_num) maps + row gathers;
    #  'banded'     — gather-free banded radius neighborhoods over the Morton
    #                 order (TPU-native; needs no kNN maps at all, so sample
    #                 prep skips every neighbor search too);
    #  'banded_knn' — the banded machinery with the reference's kNN
    #                 semantics: per-query k-th-NN squared-distance
    #                 thresholds (banded_knn_tau) decide membership on the
    #                 fly, normalization is the within-tau count (== k), and
    #                 per-layer kernel_points parameters are honored.  Exact
    #                 vs 'gather' whenever the true k-NN sit inside the band;
    #                 the fast path for reference-.t7 evaluation.
    # kpconv_band_width is the half-band at pyramid level 0; the FPN doubles
    # it per support level (the width needed for ~99% influence-mass
    # coverage scales that way — tools/band_study.py).
    # 'banded' is the framework default (the TPU-native fast path; ~2.5x
    # end-to-end); evaluation of reference .t7 checkpoints auto-selects
    # 'gather' for parity (evaluation/eval_all.py) since those weights were
    # trained with kNN neighborhoods.
    kpconv_impl: str = "banded"
    kpconv_tile: int = 128
    kpconv_band_width: int = 256
    # Pyramid-level point ordering: 'xz' = 2-D Z-order on the camera-frame
    # ground plane (x lateral, z depth) — LiDAR scenes are ground-plane-
    # dominated, so at equal coverage 'xz' needs ~1.8x narrower bands than
    # 3-D 'xyz' (tools/order_study.py).  Gather-path kNN maps are
    # ordering-invariant, so this only affects the banded path's coverage.
    pyramid_ordering: str = "xz"
    # Per-support-level band widths for the FPN under 'xz' ordering
    # (multiples of 128 — the TPU lane width; anything else is padded up by
    # Mosaic and costs the next multiple anyway).  Every FPN conv measures
    # >= 98.4% influence-mass coverage with this plan (tools/order_study.py),
    # better than the old xyz/256-doubling default's 98.2% worst at ~1.8x
    # less aggregation work.  None falls back to kpconv_band_width * 2^lvl.
    kpconv_band_plan: tuple = (128, 256, 640, 1024, 2560)
    # banded aggregation backend: 'auto' (pallas on TPU, xla elsewhere),
    # 'xla' (lax.map scan), or 'pallas' (fused VMEM kernel,
    # ops/kpconv_kernel.py; interpret-mode on CPU — slow, tests only)
    kpconv_kernel: str = "auto"
    # Strided-shortcut maxpool formulation per SUPPORT level (None entries
    # use the banded select kernel; an int k uses the compacted top-k form —
    # ops/banded.banded_compact_maxpool — which selects each query's k
    # nearest band rows and maxes over those, O(tile*k*C) instead of
    # O(tile*band*C)).  The compacted form pays a top_k + k-row gather;
    # measured SLOWER than the guarded Pallas rescan at every FPN level
    # (PERF.md round-2 A/B: 50-70 ms vs 21-44) — the ~8 ns/row gather is
    # the floor.  Kept for the kNN-semantics parity variants, not speed.
    maxpool_compact_plan: tuple | None = None
    # KPConv aggregation formulation per SUPPORT level (None/0 entries use
    # the full-band path — Pallas kernel on TPU; an int k uses the compacted
    # top-k form, ops/banded.banded_compact_aggregate: influence over each
    # query's k nearest band rows only, O(tile*k*K) VPU work instead of
    # O(tile*band*K)).  Same gather-floor geometry as maxpool_compact_plan;
    # the aggregation side has not been A/B'd on TPU, but the maxpool
    # study's gather-floor arithmetic (PERF.md §9(d): ~8 ns/row over
    # tile*k*C rows exceeds the whole guarded rescan) applies unchanged.
    # Parity use only.
    aggregate_compact_plan: tuple | None = None
    # Dynamic per-tile band starts per SUPPORT level (ops/banded.py::
    # dynamic_band_starts): 0/None entries keep the static proportional
    # band plan; an int W measures each query tile's exact in-reach index
    # span on device each forward and centers a W-wide window on it —
    # the deep levels' static bands cover most of the level (enc5_1 scans
    # 2304 of 2560 rows) while real spans are far narrower, and the
    # maxpool/aggregation kernels' select/influence work scales with the
    # scanned width.  Shared per (query level, support level) pair like
    # tau.  Differentiable since round 4 (forward-geometry backward stack
    # kernels + window scatter-add), so training configs may enable it too.
    # A window narrower than the tile's in-reach span DROPS the out-of-
    # window neighbors (that is the speedup) — accuracy vs width is
    # measured in tools/acc_study.py; see PERF.md round-4.
    kpconv_dynamic_plan: tuple | None = None
    # Same, for the SELF (query level == support level) pairs.  None falls
    # back to kpconv_dynamic_plan for both pair kinds; a separate plan exists
    # because the measured wins differ (tools/dyn_mp_ab, B=8 KITTI scale):
    # the cross pairs carry the strided-shortcut maxpool (select-bound, 2x+
    # from a coverage-matched window) while self pairs only aggregate —
    # MXU/BW-bound and near-free at deep levels, and at L1 the dynamic
    # window measured *slower* than its static band.
    kpconv_dynamic_plan_self: tuple | None = None
    # Window placement estimator for dynamic starts: 'best' (default,
    # round 4) = the width-W window holding maximum in-reach multiplicity
    # mass (cumsum sliding window — optimal for kept pairs at the width);
    # 'centroid' / 'span' = the round-3 estimators (see
    # ops/banded.dynamic_band_starts).
    kpconv_dynamic_center: str = "best"
    # Fold each strided block's shortcut maxpool into its conv's Pallas band
    # pass (ops/residual_kernel.py).  Default OFF: the round-5 A/B measured
    # the fusion a wash at the w192 serving geometry (the pair is VPU-bound,
    # not DMA/d2-bound — see PERF.md "fused residual band pass"); the kernel
    # stays available for re-testing as geometries change.
    kpconv_residual_fused: bool = False
    # Per-support-level kNN window widths for impl='banded_knn' (the `.t7`
    # reproduction path): each pair's scan is windowed to the width-W span
    # holding maximum in-tau mass (ops/banded.dynamic_knn_starts).  Unlike
    # the radius windows, kNN windows are EXACT wherever a tile's k-nearest
    # rows fit W (they are Morton-local by construction); coverage measured
    # in tools/knn_window_ab.  None = full static bands (round-4 behavior).
    # Forward-only: training with this set raises in the kernels' VJPs.
    kpconv_knn_window_plan: tuple | None = None
    # share one influence tensor per (level, radius) across sibling KPConv
    # blocks (valid while all layers use the canonical kernel disposition).
    # eval of reference .t7 checkpoints sets this False: each reference layer
    # carries its own rotated/jittered kernel_points buffer, imported into
    # per-layer parameters (reference kpconv.py:64-65, kernel_points.py:429-453).
    kpconv_shared_influence: bool = True

    # training (reference: options.py:45-59)
    epoch: int = 25
    train_batch_size: int = 1
    val_batch_size: int = 1
    num_workers: int = 8
    lr: float = 1e-3
    min_lr: float = 1e-5
    lr_decay_step: float = 0.25
    lr_decay_scale: float = 0.5
    val_freq: int = 100

    # fine-cell decode: 'label' (consistent with the training labels) or
    # 'reference' (the reference eval's swapped decode, eval_all.py:104-105 —
    # needed to reproduce the published RRE/RTE exactly; see
    # models/network.py::fine_match_xy)
    fine_decode: str = "label"

    # test-mode inference (reference: network.py:147-150 threshold decay loop)
    test_score_thresholds_start: float = 0.9
    test_score_thresholds_step: float = 0.02
    test_score_thresholds_num: int = 46  # 0.9 down to 0.0

    # on-device RANSAC (replaces cv2.solvePnPRansac(iterationsCount=10000),
    # reference eval_all.py:107; hypotheses run in parallel on the MXU)
    ransac_hypotheses: int = 512
    ransac_inlier_px: float = 8.0  # cv2 default reprojectionError
    ransac_refine_iters: int = 2

    # numerics
    compute_dtype: str = "float32"

    # derived static shapes -------------------------------------------------
    @property
    def pe_H(self) -> int:
        return self.img_H // 8

    @property
    def pe_W(self) -> int:
        return self.img_W // 8

    @property
    def num_img_tokens(self) -> int:
        return self.pe_H * self.pe_W

    @property
    def pyramid_sizes(self) -> Tuple[int, ...]:
        sizes = []
        n = self.num_pc
        for _ in range(self.num_stages):
            sizes.append(n)
            n //= 2
        return tuple(sizes)

    @property
    def num_superpoints(self) -> int:
        return self.pyramid_sizes[-1]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
