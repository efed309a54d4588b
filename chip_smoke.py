#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and `.t7` eval paths, its
on-disk KITTI and nuScenes data paths, its compacted plans, data-parallel
step and measurement tool, on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,serve --requests 3
    python3 chip_smoke.py --phases device,build,kitti,nuscenes
    python3 chip_smoke.py --phases device,build,t7,t7_gather

Phases (each prints one or more lines; any failure exits non-zero before
the last line):
  device   require CUDA; print the nvidia-smi name and power limit; TF32 off
  build    compile cofii2p_tpu_torch/csrc/*.cu with nvcc, one process per
           source (first use, cached by source hash under
           build/cofii2p_tpu_torch/)
  kernels  each CUDA kernel against its plain PyTorch version: the serving
           kernels at the serving shapes, fp32 and bf16 (the fused KPConv
           at lvl0 4->64 on fp32 features and 32->32, lvl1 <- lvl0
           32->64, lvl2 static and w192, lvl4 512->512; the maxpool at the
           four strided shortcuts, C = 128 to 1024 on their levels, static
           and w192, bit-equal and the same bits on two launches; the
           attention with serving's normalised queries and with randn
           ones, its bf16 output within bf16's rounding of the fp32 plain
           version on the same inputs plus 5e-4); the training
           kernels (aggregate, transposed aggregate, tie count, maxpool
           backward) at the trainer's fp32 shapes, B=8, on clouds with
           duplicated points so that maxima tie, the aggregate (tensor
           cores, fp32 by 3xTF32) also on encoder4_2's 2176-row band; the
           k-NN kernels (tau,
           tau KPConv fused and aggregate, tau maxpool) at the `.t7`
           path's fp32 shapes, B=8, on the same clouds, so that k-th and
           (k+1)-th distances and maxima tie: tau and the maxpool
           bit-equal (tau at the 9 level pairs, on w256 windows and with
           kk = band, the last two the same bits on two launches; the
           maxpool at the four strided shortcuts, C = 128 to 1024, fp32
           and bf16, the same bits on two launches),
           the KPConvs (tensor cores, fp32 by 3xTF32) at every width of the
           FPN, on bands of one membership segment and of two (2176 and
           2304 rows), with equal active-row counts; the backward kernels of
           `train --fast` (window transpose, window maxpool backward, the
           tie count on windows) on the w256 windows and of `banded_knn`
           training (tau transpose on the tensor cores, tau maxpool
           backward, the tie count by tau) on the k-NN pairs' static bands:
           tie counts bit-equal (the tie count at the four strided
           shortcuts, C = 128 to 1024, by radius on static bands, on w256
           windows and by tau, also in bf16 at C = 256, the same bits on
           two launches), transposes rel <= 1e-4, the tau transpose the
           same bits on two launches, maxpool backwards rel <= 1e-5 and
           the same bits on two launches (the static one at the four
           strided shortcuts, also bf16 at C = 256; the window one at the
           three windowed shortcuts; the tau one at the four tau ones),
           the window scatter bit-equal on the kernel's own stack; the fused residual
           band pass (#16) at the four strided blocks' serving shapes (bf16,
           w192) and the three fp32 static ones it takes, on clouds with
           duplicated points: counts equal and shortcuts bit-equal to the
           plain version and to the pair it fuses (#1 then #3), the conv
           bit-equal to #1's and within #1's thresholds of the plain
           version, with the pair's time beside the kernel's; the kernel's
           and the plain version's time (CUDA events) and the least time
           the card could take for the same work (the larger of bytes over
           3.35 TB/s and operations over the peak rate of their type); the
           fused KPConv and the attention also timed in fp32 (3xTF32), the
           attention beside the library's fp32 attention; then every
           KPConv kernel (#1 fp32 and bf16, #2, #6, #7, #9, #10, #11, #16)
           again at K = 12 and K = 20 kernel points from the port's
           generator, on its smallest shape, at the K = 15 gates; last,
           the point branch's group-norm kernels (#18) on each of the 47
           group-norm calls of a bf16 B=8 serving forward: statistics
           within 1e-5 of the plain version's and the same bits on two
           launches, the apply bit-equal on the plain statistics, the
           calls' summed kernel, plain and bound ms
  fp32     the whole forward at B=1 in fp32 through the kernels and through
           the plain versions: FPN and transformer outputs agree
  grad     one fp32 train step at B=1 on a KITTI-scale frame through the
           kernels and through the plain versions under autograd
           (kpconv_kernel='xla'), same weights and draws: losses agree to
           1e-4 and every parameter gradient to 1e-3 (rms-floored)
  pose     the pipeline's EPnP-RANSAC at serving size (8 frames and 1,
           1280 correspondences, 512 hypotheses) through the kernels
           (csrc/ransac_pnp.cu) and through the plain version on the same
           draws, on scenes of known pose with outliers and masked rows
           (B = 8 recovers the pose) and on junk correspondences: the same
           samples, hypothesis counts on >= 99.9%, inlier counts and success
           flags, R and t within 1e-4, NaN alike; each timed as a graph
           replay beside its bound
  serve    the bench.py serving config (bf16, w192 windows, fused
           attention) with seeded random weights: a warm-up, then 10
           requests of 8 KITTI-shaped synthetic frames through
           make_eval_body; launch counts per forward, finite network
           outputs, finite proper rotations wherever RANSAC succeeded,
           frames/s and peak memory.  Random weights give few and junk
           correspondences, on which the JAX package's ransac_pnp itself
           returns NaN poses for some frames; those are counted, not
           failed.  Then the drift readout: one B=8 forward through the
           kernels and through the plain versions on the card (same
           weights, frames and draws), the drift tool's four readings
           (cofii2p_tpu_torch/tools/window_drift.py::drift), each within
           twice the CUDA-core kernels' reading plus one point
           (SERVE_DRIFT_LIMITS).
  graphs   the serving body replayed as CUDA graphs (the stages that
           utils/cuda_graphs.py::serving_stages gives) against the eager
           body (make_eval_body's stages=()), at the serving configuration
           (B = 8 and 1), the `.t7` one under banded_knn and under gather
           (B = 8; gather's prep stays eager) and each of VARIANTS (B = 8),
           on the same frames and draws: every output bit-equal in the
           capturing and in a replayed request, a replayed request with
           synchronising CUDA calls made errors (where prep replays), the
           device ms of kernels launched inside KPConv ranges (as the
           benchmark's traced runs set them) within 2x of the eager body's,
           each stage's graph nodes, ms a request (closed loop, poses read
           back) and peak memory of both.
  serve_resfuse  serve with kpconv_residual_fused=True (same seeded
           weights): launches per forward (4 fused strided blocks, 10
           KPConvs, no separate maxpool), the same output checks and
           frames/s; then one B=8 forward with and without the flag on the
           same frames and draws (FPN outputs within 1e-3, the 4 shortcuts
           bit-equal), and one B=1 fp32 static-band forward with the flag
           through the kernels (3 fused blocks) and through
           kpconv_kernel='xla' (outputs within 1e-3).
  train    `python -m cofii2p_tpu_torch.train kitti --synthetic --steps 4
           --batch_size 8` through train.main (fp32, static bands, full
           KITTI width, val at step 4): launches per step of each kernel,
           finite losses and gradient norm, parameters moved, the
           checkpoint restores and one eval_step runs on it; ms/step,
           frames/s and peak memory.  Then the restored model through
           evaluation/pipeline.py's make_eval_body (what eval_all.main runs
           for a port checkpoint under `kitti`: fp32, static bands, 12
           launches of the fused KPConv a batch): 3 batches of 8 synthetic
           frames, the median ms and frames/s of batches 2-3, finite poses
           wherever RANSAC succeeded.
  t7       a reference-layout state dict from seeded weights, every KPConv
           with its own rotated and jittered kernel points, written as
           ref.t7; `python -m cofii2p_tpu_torch.evaluation.eval_all ref.t7
           kitti --synthetic --synthetic_frames 16 --batch_size 8` through
           eval_all.main (fp32 k-NN semantics, fused attention): the 16
           per-frame dumps and both error arrays, launches per forward of
           each kernel, finite poses wherever RANSAC succeeded, frames/s of
           the second batch and peak memory; then one B=1 forward of the
           same model through the kernels and through kpconv_kernel='xla':
           every pair's tau bit-equal, every KPConv's active-row count
           equal, FPN outputs within 1e-4.
  train_fast  as train with --fast (w256 dynamic windows on support levels
           1-3): launches per step, finite losses, parameters moved, the
           checkpoint restores; then one B=1 step's 7 window KPConvs and 3
           window maxpools replayed on their own inputs through the
           autograd Functions and through autograd of the plain versions.
  train_knn  as train with kpconv_impl=banded_knn: the same checks, and
           every tau KPConv and tau maxpool of a B=1 step with per-layer
           rotated and jittered kernel points replayed likewise.
  kitti    the on-disk KITTI path: a fixture tree in the real layout
           (cofii2p_tpu_torch/data/fixtures.py; 376x1241 images, 7 x 120000
           clouds; 16 frames of sequence 00, 8 of 09 and 4 of 10) written
           from --seed into a temporary directory; the loader alone over
           its 24 val frames (frames/s); `train kitti data_path=<tree>
           --steps 4 --batch_size 8` through train.main (launches per step
           as PER_STEP, finite losses, steps 2-4 fed by the loader in
           frames/s); then `eval_all <its checkpoint> kitti
           data_path=<tree> --batch_size 8` through eval_all.main (3
           batches, launches per batch as PER_EVAL_FORWARD, the dumps and
           error arrays, finite poses wherever RANSAC succeeded; batches
           2-3 in frames/s, with and without the wait for the loader).
  nuscenes the same on a nuScenes tree in the builder's layout (320x640
           images, 4 x 50000 camera-frame clouds, 16 frames a split) at
           NuScenesConfig (160x320 crops, intensity-only features): the
           loader alone, 2 train steps (the has_normals=False supervision)
           and `eval_all none nuscenes data_path=<tree>` on seeded random
           weights.
  t7_gather  the t7 phase's seeded ref.t7 through `eval_all ref.t7 kitti
           --synthetic --batch_size 8 kpconv_impl=gather` (fp32, the k-NN
           index maps built on the card, per-layer kernel points, fused
           attention), as users run it, its stages replayed as CUDA
           graphs but prep (whose k-NN maps wait for the card): 16
           attention launches a forward, twice in the capturing batch and
           none after, no other kernel, prep not captured and every other
           stage captured, the dumps and error arrays, finite poses
           wherever RANSAC succeeded; ms and frames/s of the second batch,
           peak memory, the
           13 k-NN map searches' time a batch (CUDA events) and its split
           into the d2 chain, the k-th value and the tie pass; then the four
           drift readings between one B=8 forward under gather and one
           under banded_knn on the same weights, frames and draws (printed,
           no limit).
  train_gather  `train kitti --synthetic kpconv_impl=gather` for 2 steps at
           B=8 through train.main (the largest of 4, 2, 1 that fits if B=8
           does not): no kernel launched, finite losses, parameters moved,
           a checkpoint; ms/step, frames/s, peak memory.
  variants two bf16 B=8 serving requests through the eager body (make_eval_body
           with stages=(); the graphs phase replays these) for each
           of VARIANTS (linear attention, LayerNorm point blocks, centroid
           windows, K = 20; span windows, K = 12): launches a forward as
           fused_contraction_fits decides at that K, #4 only under
           'pallas'; finite outputs and poses where RANSAC succeeded; ms a
           request; then every kernel call of a third request held against
           its plain version on its own inputs at the kernels phase's bf16
           gates (#1 and #2 at K = 20 and 12 up to Cin 512 included, against
           the bf16 plain version, which rounds as they do).
  serve_compact  the serving config with maxpool_compact_plan (128,) and
           aggregate_compact_plan (128, 0, 0, 0, 128) (the support levels
           its windows leave static): 3 requests of B=8, launches a forward
           9/3/16 of #1/#3/#4 and no tau, finite outputs; then on one
           forward's own inputs encoder2_1's compacted shortcut bit-equal
           to #3 and encoder1_2's compacted aggregation in fp32 within
           1e-4 rel of #2 on every query with <= k in reach, its counts
           equal to #2's; and the drift against the plain versions within
           SERVE_DRIFT_LIMITS.
  t7_compact  the `.t7` config (banded_knn, per-layer kernel points)
           with every conv and shortcut compacted at k = 128: 2 batches of
           B=8 that launch #4 alone (no tau); then, outside them, each
           strided shortcut's inputs through #5 and #8 and the compacted
           k-NN maxpool: bit-equal on every query whose tau admits
           exactly k rows (no tie or near-tie at the k-th distance).
  train_compact  `train kitti --synthetic` with maxpool_compact_plan
           (0, 0, 0, 128) and aggregate_compact_plan (0, 0, 0, 128, 128),
           2 steps of B=8 through train.main: launches a step 9/8/3/3/3 of
           #2/#9/#3/#12/#13, finite losses, parameters moved; ms and peak.
  train_dp one train.main step of B=8 alone and under a world-size-1
           NCCL group on a FileStore (the data-parallel path), both under
           torch.use_deterministic_algorithms: parameters, buffers and
           metrics bit-equal.
  flops    `get_flops_fps` on the serving config at B=8: every line
           printed (parameters, frames/s, FLOPs, activations, peak, PnP).
The second line before the last is the JSON kernel summary, then the
nvidia-smi name and power limit, then {"ok": true, "device": {...}}.
Long logs go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PHASES = ("device", "build", "kernels", "fp32", "grad", "pose", "serve", "graphs", "serve_resfuse", "train", "t7",
          "train_fast", "train_knn", "kitti", "nuscenes", "t7_gather", "train_gather", "variants", "serve_compact",
          "t7_compact", "train_compact", "train_dp", "flops")
BATCH = 8
REQUESTS = 10  # timed requests a serve phase: a request is ~0.13 s, where host jitter of a few ms shows
TRAIN_STEPS = 4
EVAL_BATCHES = 3  # batches of the fp32 static eval reading; the first is a warm-up
# the real-data phases' fixture trees: KITTI sequence 00's 16 frames make
# 32 train samples (4 steps of 8), sequences 09 and 10 24 val samples (3
# eval batches); nuScenes 16 frames a split (2 steps, 2 eval batches)
KITTI_FIXTURE_FRAMES = {0: 16, 9: 8, 10: 4}
NUSCENES_FIXTURE_FRAMES = {"train": 16, "test": 16}
NUSCENES_TRAIN_STEPS = 2
FIXTURE_POINTS = {"kitti": 120000, "nuscenes": 50000}  # a frame's cloud, as the datasets' sweeps hold
# the KITTI FPN's group norms: encoder1_1's, four in encoder1_2, ten in each
# of stages 2-5 (the strided block's unary1, norm_conv, unary2; unary1,
# norm_conv, unary2 and unary_shortcut; unary1, norm_conv, unary2), both
# decoders' with a norm
NORM_SITES = 47
# the serving plan's windowed (query level, support level) pairs: the
# cross pairs of support levels 1-3 and the self pairs of levels 2-3, one
# placement (#19) each
WINDOW_PAIRS = 5
PER_FORWARD = {"kpconv_fused": 14, "maxpool": 4, "attention": 16, "residual_fused": 0, "point_norm": NORM_SITES,
               "window_starts": WINDOW_PAIRS}
# with kpconv_residual_fused: the 4 strided blocks' conv and shortcut in one
# pass each (all fit residual_fused_fits in bf16 at w192), the other 10 convs
PER_RESFUSE_FORWARD = {"residual_fused": 4, "kpconv_fused": 10, "maxpool": 0, "attention": 16,
                       "point_norm": NORM_SITES, "window_starts": WINDOW_PAIRS}
# the serve phase's drift readings (the four of the drift tool,
# cofii2p_tpu_torch/tools/window_drift.py::drift) between the kernels and
# the plain versions, measured with the CUDA-core #1 and #4 before their
# tensor-core redesign (H100 80GB HBM3, seed 0); a reading may
# grow to twice that plus one point: 0.01 for a fraction, 1e-2 for the score
SERVE_DRIFT_PARENT = dict(argmax=0.0369, selection=0.0006, fine_cell=0.0625, score=0.01324)
SERVE_DRIFT_LIMITS = {k: 2 * v + 0.01 for k, v in SERVE_DRIFT_PARENT.items()}
# the bf16 attention kernel, beyond bf16's rounding of the fp32 plain
# version on its inputs: the fp32 sums' order and P split into two bf16
# terms (2^-16 relative) leave ~1e-5 at these magnitudes
ATTN_BF16_EXCESS = 5e-4
# launches per train step: 14 KPConvs forward, 13 feature gradients (not
# encoder1_1's, whose input needs none), 4 strided shortcuts forward and
# backward; no fused KPConv, no fused attention and no group-norm kernels
# while differentiating
NOT_TRAINED = {"kpconv_fused": 0, "attention": 0, "kpconv_fused_tau": 0, "residual_fused": 0, "point_norm": 0}
PER_STEP = {"kpconv_aggregate": 14, "kpconv_transpose": 13, "maxpool": 4, "maxpool_count": 4, "maxpool_bwd": 4,
            "kpconv_transpose_dyn": 0, "maxpool_bwd_dyn": 0, "knn_tau": 0, "kpconv_aggregate_tau": 0,
            **NOT_TRAINED}
# --fast: w256 windows on the cross pairs of support levels 1-3 and the self
# pairs of levels 2-3, i.e. encoder3_1..5_1's 7 KPConvs (#10 in their
# backward) and the 3 shortcuts of encoder3_1, 4_1, 5_1 (#14); the other 7
# convs and encoder2_1's shortcut on static bands
PER_FAST_STEP = {"kpconv_aggregate": 14, "kpconv_transpose": 6, "kpconv_transpose_dyn": 7, "maxpool": 4,
                 "maxpool_count": 4, "maxpool_bwd": 1, "maxpool_bwd_dyn": 3, "knn_tau": 0, **NOT_TRAINED}
# banded_knn: one tau per (query level, support level) pair, the 14 convs
# on the aggregate tau kernel (as JAX's _tau_fwd when differentiated), 13
# tau transposes, 4 tau maxpools with their tau tie counts and backwards;
# none of the radius kernels
PER_KNN_STEP = {"knn_tau": 9, "kpconv_aggregate_tau": 14, "kpconv_transpose_tau": 13, "maxpool_tau": 4,
                "maxpool_count": 4, "maxpool_bwd_tau": 4, "kpconv_aggregate": 0, "kpconv_transpose": 0,
                "maxpool": 0, "maxpool_bwd": 0, **NOT_TRAINED}
# launches per fp32 `.t7` forward: one tau per (query level, support level)
# pair (5 self, 4 cross), 12 KPConvs that fit the fused kernel and the two
# Cin = 512 ones on the aggregate kernel, 4 strided shortcuts, 16 attention
# calls; none of the radius kernels
# launches per fp32 static eval batch of a port-trained model (A'): the 12
# KPConvs that fit the fused kernel, the two Cin = 512 ones on the
# aggregate, 4 strided shortcuts; full attention, as KITTIConfig has it
PER_EVAL_FORWARD = {"kpconv_fused": 12, "kpconv_aggregate": 2, "maxpool": 4, "attention": 0, "residual_fused": 0,
                    "kpconv_fused_tau": 0, "point_norm": NORM_SITES}
PER_T7_FORWARD = {"knn_tau": 9, "kpconv_fused_tau": 12, "kpconv_aggregate_tau": 2, "maxpool_tau": 4, "attention": 16,
                  "kpconv_fused": 0, "kpconv_aggregate": 0, "maxpool": 0, "residual_fused": 0,
                  "point_norm": NORM_SITES}
# the variants phase's serving configurations (the serving one otherwise)
VARIANTS = (("linear attention, LayerNorm point blocks, centroid windows, K = 20",
             dict(attention="linear", norm="ln", kpconv_dynamic_center="centroid", kernel_size=20)),
            ("span windows, K = 12", dict(kpconv_dynamic_center="span", kernel_size=12)))
T7_DUMP_KEYS = {"GT_P", "pred_P", "K", "fine_xy", "corr_mask", "object_points", "superpoints_score"}
KERNELS = {
    "kpconv_fused": ("cofii2p_tpu_torch/csrc/kpconv_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:1007"),
    "maxpool": ("cofii2p_tpu_torch/csrc/maxpool_fwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:208"),
    "attention": ("cofii2p_tpu_torch/csrc/attention.cu", "cofii2p_tpu/ops/attention_kernel.py:53"),
    "kpconv_aggregate": ("cofii2p_tpu_torch/csrc/kpconv_tau_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:228"),
    "kpconv_transpose": ("cofii2p_tpu_torch/csrc/kpconv_transpose_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:516"),
    "maxpool_count": ("cofii2p_tpu_torch/csrc/maxpool_fwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:315"),
    "maxpool_bwd": ("cofii2p_tpu_torch/csrc/maxpool_route.cu", "cofii2p_tpu/ops/maxpool_kernel.py:537"),
    "knn_tau": ("cofii2p_tpu_torch/csrc/knn_tau.cu", "cofii2p_tpu/ops/tau_kernel.py:110"),
    "kpconv_aggregate_tau": ("cofii2p_tpu_torch/csrc/kpconv_tau_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:691"),
    "kpconv_fused_tau": ("cofii2p_tpu_torch/csrc/kpconv_tau_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:1212"),
    "maxpool_tau": ("cofii2p_tpu_torch/csrc/maxpool_fwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:657"),
    "kpconv_transpose_dyn": ("cofii2p_tpu_torch/csrc/kpconv_transpose_mma.cuh",
                             "cofii2p_tpu/ops/kpconv_kernel.py:442"),
    "kpconv_transpose_tau": ("cofii2p_tpu_torch/csrc/kpconv_transpose_mma.cuh",
                             "cofii2p_tpu/ops/kpconv_kernel.py:826"),
    "maxpool_bwd_dyn": ("cofii2p_tpu_torch/csrc/maxpool_route.cu", "cofii2p_tpu/ops/maxpool_kernel.py:452"),
    "maxpool_bwd_tau": ("cofii2p_tpu_torch/csrc/maxpool_route.cu", "cofii2p_tpu/ops/maxpool_kernel.py:783"),
    "residual_fused": ("cofii2p_tpu_torch/csrc/residual_fused.cu", "cofii2p_tpu/ops/residual_kernel.py:386"),
    # no TPU kernel: the JAX package's RANSAC is plain jnp; added because the
    # plain version is a chain of ~24k tiny launches
    "ransac_pnp": ("cofii2p_tpu_torch/csrc/ransac_pnp.cu", "none (cofii2p_tpu/pose/ransac.py is plain jnp)"),
    # no TPU kernel: the JAX package's group norm chain is plain jnp, which
    # XLA fuses; added because PyTorch runs it as ~10 passes a site
    "point_norm": ("cofii2p_tpu_torch/csrc/point_norm.cu",
                   "none (cofii2p_tpu/models/layers.py PointGroupNorm, leaky_relu are plain jnp)"),
    # no TPU kernel: the JAX package's window placement is plain jnp, which
    # XLA fuses; added because PyTorch runs it as ~8 broadcast passes a pair
    "window_starts": ("cofii2p_tpu_torch/csrc/window_starts.cu",
                      "none (cofii2p_tpu/ops/banded.py dynamic_band_starts, dynamic_knn_starts are plain jnp)"),
}
# the RANSAC wrapper's calls when a serving body first meets a shape: the
# warm-up call outside CUDA graph capture and the captured one; replays
# launch nothing from Python
RANSAC_AT_CAPTURE = 2
# a serving body (evaluation/pipeline.py::make_eval_body) replays every
# stage as CUDA graphs: the first request of a batch shape runs each stage
# twice (the warm-up outside capture, then the captured call), so each
# kernel launches twice its count a forward, and later requests launch none
AT_CAPTURE = 2
# the gather `.t7` forward (kpconv_impl=gather): the 16 attention calls, the
# group norms and no other kernel; each batch builds 13 k-NN maps (5 self, 4
# subsampling, 4 upsampling)
PER_T7_GATHER_FORWARD = {**{name: 0 for name in KERNELS}, "attention": 16, "point_norm": NORM_SITES}
MAP_SEARCHES = 13
# the path whose launch counts the summary reports for each kernel (serve's
# ransac_pnp: its calls at the RANSAC graph's capture)
SERVE_KERNELS = ("kpconv_fused", "maxpool", "attention", "ransac_pnp", "point_norm", "window_starts")
TRAIN_KERNELS = ("kpconv_aggregate", "kpconv_transpose", "maxpool_count", "maxpool_bwd")
T7_KERNELS = ("knn_tau", "kpconv_aggregate_tau", "kpconv_fused_tau", "maxpool_tau")
FAST_KERNELS = ("kpconv_transpose_dyn", "maxpool_bwd_dyn")
KNN_TRAIN_KERNELS = ("kpconv_transpose_tau", "maxpool_bwd_tau")
SERVE_RESFUSE_KERNELS = ("residual_fused",)


def wrappers():
    """Every kernel wrapper by its summary name (each counts its launches)."""
    from cofii2p_tpu_torch.ops import attention_kernel as att
    from cofii2p_tpu_torch.ops import kpconv_kernel as kpk
    from cofii2p_tpu_torch.ops import maxpool_kernel as mpk
    from cofii2p_tpu_torch.ops import norm_kernel as nk
    from cofii2p_tpu_torch.ops import residual_kernel as rk
    from cofii2p_tpu_torch.ops import tau_kernel as tk
    from cofii2p_tpu_torch.ops import window_kernel as wk
    from cofii2p_tpu_torch.pose import ransac

    return {"kpconv_fused": kpk.banded_kpconv_fused, "maxpool": mpk.banded_maxpool_fused,
            "attention": att.fused_attention, "kpconv_aggregate": kpk.banded_kpconv_aggregate_fused,
            "kpconv_transpose": kpk.banded_kpconv_transpose_fused,
            "maxpool_count": mpk.banded_maxpool_tie_count_fused, "maxpool_bwd": mpk.banded_maxpool_backward_fused,
            "knn_tau": tk.banded_knn_tau_kernel, "kpconv_aggregate_tau": kpk.banded_kpconv_aggregate_tau,
            "kpconv_fused_tau": kpk.banded_kpconv_fused_tau, "maxpool_tau": mpk.banded_maxpool_tau,
            "kpconv_transpose_dyn": kpk.banded_kpconv_transpose_dyn_fused,
            "kpconv_transpose_tau": kpk.banded_kpconv_transpose_tau_fused,
            "maxpool_bwd_dyn": mpk.banded_maxpool_backward_dyn_fused,
            "maxpool_bwd_tau": mpk.banded_maxpool_backward_tau_fused,
            "residual_fused": rk.banded_residual_fused, "ransac_pnp": ransac.ransac_pnp,
            "point_norm": nk.point_group_norm_fused, "window_starts": wk.best_windows_fused}


def body_launches(per_forward, first):
    """A serving body's launches in one request: AT_CAPTURE times a
    forward's in the first request of a batch shape, none later."""
    return {k: AT_CAPTURE * v if first else 0 for k, v in per_forward.items()}


def stage_nodes():
    """Nodes of each serving graph stage's captures (utils/cuda_graphs.py::
    STAGES), by stage, from the counters (nodes over captures)."""
    from cofii2p_tpu_torch.utils.cuda_graphs import STAGES, stage_prefix
    from cofii2p_tpu_torch.utils.profiling import counter

    return {st: counter(stage_prefix(st) + ".graph_nodes").value
            // max(1, counter(stage_prefix(st) + ".captures").value) for st in STAGES}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in wrappers().items()}


class Tally:
    """Per kernel: the summed times and bounds of the cases timed."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain_ms, bound_ms_by, library_ms=None):
        r = self.rows.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                            t_bytes=0.0, t_ops=0.0, library_ms=None))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        b_ms, by = bound_ms_by
        r["bound_ms"] += b_ms
        r["t_bytes" if by == "bytes" else "t_ops"] += b_ms
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms

    def results(self):
        return {name: dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                           bound_ms=r["bound_ms"], bound_by="bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
                           library_ms=r["library_ms"])
                for name, r in self.rows.items()}


class PhaseError(RuntimeError):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rel_err(a, ref):
    """max |a - ref| / max(|ref|, rms(ref)), in float64 (bench.py:137-143)."""
    a, ref = a.double(), ref.double()
    rms = ref.pow(2).mean().sqrt().item() + 1e-30
    return ((a - ref).abs() / ref.abs().clamp(min=rms)).max().item()


def bf16_excess(out, ref):
    """How far a bf16 output lies beyond bf16's rounding of an fp32 result:
    max(|out - ref| - 2^-8 |ref|), 2^-8 being bf16's unit roundoff."""
    ref = ref.double()
    return ((out.double() - ref).abs() - ref.abs() * 2.0**-8).max().item()


def synthetic_cloud(n, gen, device):
    """A Morton-ordered ground-plane cloud of KITTI extent."""
    import torch

    from cofii2p_tpu_torch.ops.pyramid import morton_order

    u = torch.rand(n, 3, generator=gen)
    pts = torch.stack([u[:, 0] * 80 - 40, u[:, 1] * 4 - 2, u[:, 2] * 80], -1)
    return pts[morton_order(pts, ordering="xz")].to(device)


def pyramid_with_duplicates(sizes, batch, gen, device, share=8):
    """Per frame, a KITTI-extent cloud in which one row in ``share``
    repeats another, as resample_fixed pads a cloud, and each next level a
    random subset of the previous one, every level Morton-ordered, as the
    pipeline builds its pyramid.  Returns the levels [(B, N_l, 3)] and, per
    row, the index of the base row it copies [(B, N_l)], so that features
    gathered by it tie exactly where coordinates do."""
    import torch

    from cofii2p_tpu_torch.ops.pyramid import morton_order

    levels, idents = [[] for _ in sizes], [[] for _ in sizes]
    base = sizes[0] - sizes[0] // share
    for _ in range(batch):
        u = torch.rand(base, 3, generator=gen)
        pts = torch.stack([u[:, 0] * 80 - 40, u[:, 1] * 4 - 2, u[:, 2] * 80], -1)
        ident = torch.cat([torch.arange(base), torch.randint(0, base, (sizes[0] - base,), generator=gen)])
        pts = pts[ident]
        for lvl, n in enumerate(sizes):
            if lvl:
                keep = torch.randperm(pts.shape[0], generator=gen)[:n]
                pts, ident = pts[keep], ident[keep]
            order = morton_order(pts, ordering="xz")
            pts, ident = pts[order], ident[order]
            levels[lvl].append(pts)
            idents[lvl].append(ident)
    return ([torch.stack(x).to(device) for x in levels], [torch.stack(x).to(device) for x in idents])


def check_kernels(device, gen, tally):
    """Each kernel against its plain version: the serving kernels at the
    serving shapes (B=8, fp32 and bf16), the training kernels at the
    trainer's fp32 shapes (B=8)."""
    import torch

    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.ops.attention_kernel import full_attention, fused_attention, fused_attention_plain
    from cofii2p_tpu_torch.ops.banded import dynamic_band_starts, kernel_reach
    from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_fused, banded_kpconv_fused_plain
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_fused, banded_maxpool_plain
    from cofii2p_tpu_torch.utils.kernel_bench import call_bound, time_ms

    cfg = KITTIConfig()
    r0, s0, plan = cfg.init_radius, cfg.init_sigma, cfg.kpconv_band_plan
    sizes = cfg.pyramid_sizes
    levels = [torch.stack([synthetic_cloud(n, gen, device) for _ in range(BATCH)]) for n in sizes]
    b = BATCH

    # --- A: fused KPConv -------------------------------------------------
    # serving's shapes: encoder1_1 (Cin 4 -> 64 on fp32 features, the
    # (32, 64) build) and encoder1_2 on lvl0's static band, a strided
    # lvl1 <- lvl0 conv on encoder2_1's band (its queries every other lvl0
    # point, a subset as the pipeline's pyramid has it: on an independent
    # cloud a query has one or two neighbours, and bf16's rounding points
    # alone, the plain version's too, move the result by over 5e-2), then
    # lvl2 static and w192 and lvl4
    # (all 1280 rows); the last element: the features stay fp32 in the bf16
    # call
    a_cases = []
    q0, q2 = levels[0], levels[2]
    q1s = q0[:, ::2].contiguous()
    a_cases.append(("lvl0 static C4->64", q0, q0, 4, 64, r0, s0, plan[0], None, True))
    a_cases.append(("lvl0 static C32", q0, q0, 32, 32, r0, s0, plan[0], None, False))
    a_cases.append(("lvl1<-0 static C32->64", q1s, q0, 32, 64, r0, s0, plan[0], None, False))
    r2_, s2_ = r0 * 4, s0 * 4
    st = dynamic_band_starts(q2, q2, kernel_reach(r2_, s2_), 128, 192, "best", max(1, q2.shape[1] // 2560))
    a_cases.append(("lvl2 static C128", q2, q2, 128, 128, r2_, s2_, plan[2], None, False))
    a_cases.append(("lvl2 w192 C128", q2, q2, 128, 128, r2_, s2_, 192, st, False))
    q4 = levels[4]
    a_cases.append(("lvl4 static C512", q4, q4, 512, 512, r0 * 16, s0 * 16, plan[4], None, False))
    for name, q, s, cin, cout, r, sg, bw, starts, f32_in in a_cases:
        f = torch.randn(b, s.shape[1], cin, generator=gen).to(device)
        w = (torch.randn(15, cin, cout, generator=gen) / cin**0.5).to(device)
        args32 = (f, q, s, w, r, sg, 15, 128, bw, torch.float32, starts)
        ref, ref_cnt = banded_kpconv_fused_plain(*args32)
        out, cnt = banded_kpconv_fused(*args32)
        torch.cuda.synchronize()
        e32 = rel_err(out, ref)
        if not torch.equal(cnt, ref_cnt):
            raise PhaseError(f"kpconv {name}: counts differ at {(cnt != ref_cnt).sum().item()} queries")
        if e32 > 1e-3:
            raise PhaseError(f"kpconv {name}: fp32 rel err {e32:.3e} > 1e-3")
        fb = f if f32_in else f.to(torch.bfloat16)
        out16, cnt16 = banded_kpconv_fused(fb, q, s, w, r, sg, 15, 128, bw, torch.bfloat16, starts)
        torch.cuda.synchronize()
        e16 = rel_err(out16, ref)
        if e16 > 5e-2:
            raise PhaseError(f"kpconv {name}: bf16 rel err {e16:.3e} > 5e-2 vs fp32 plain")
        args16 = (fb, q, s, w, r, sg, 15, 128, bw, torch.bfloat16, starts)
        ref16, cnt16_ref = banded_kpconv_fused_plain(*args16)
        if not torch.equal(cnt16, cnt16_ref):
            raise PhaseError(f"kpconv {name}: bf16 counts differ at {(cnt16 != cnt16_ref).sum().item()} queries")
        k_ms = time_ms(lambda: banded_kpconv_fused(*args16))
        k32_ms = time_ms(lambda: banded_kpconv_fused(*args32))
        p_ms = time_ms(lambda: banded_kpconv_fused_plain(*args16), 3)
        n = s.shape[1]
        bd = call_bound("banded_kpconv_fused", args16)
        # the timed kernel (bf16, tensor cores) against the plain version on its inputs
        tally.add("kpconv_fused", (out16 - ref16).abs().max().item(), k_ms, p_ms, bd)
        e16_same = rel_err(out16, ref16)
        del ref16
        bd32 = call_bound("banded_kpconv_fused", args32)
        say("kernels", f"kpconv_fused {name} B={b} N={n}: fp32 rel {e32:.2e}, bf16 rel {e16:.2e} "
            f"(vs the bf16 plain version {e16_same:.2e}), counts equal; bf16 kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]}); fp32 (3xTF32) kernel {k32_ms:.3f} ms, "
            f"bound {bd32[0]:.3f} ms ({bd32[1]})")

    # --- B: maxpool ------------------------------------------------------
    # the four strided shortcuts at their levels (encoder2_1 .. encoder5_1);
    # the C = 128 and 512 cases draw from generators of their own, so the
    # checks after them see the same draws of ``gen`` as before
    for c, ql, sl, fgen in ((128, 1, 0, torch.Generator().manual_seed(3)), (256, 2, 1, gen),
                            (512, 3, 2, torch.Generator().manual_seed(4)), (1024, 4, 3, gen)):
        q, s = levels[ql], levels[sl]
        r, sg = r0 * 2 ** (sl), s0 * 2 ** (sl)
        ra = kernel_reach(r, sg)
        st = dynamic_band_starts(q, s, ra, 128, 192, "best", max(1, s.shape[1] // 2560))
        for mode, bw, starts in (("static", plan[sl], None), ("w192", 192, st)):
            k32_ms = 0.0
            for dtype in (torch.float32, torch.bfloat16):
                f = torch.randn(b, s.shape[1], c, generator=fgen).to(device, dtype)
                ref = banded_maxpool_plain(f, q, s, ra, 128, bw, starts)
                out = banded_maxpool_fused(f, q, s, ra, 128, bw, starts)
                again = banded_maxpool_fused(f, q, s, ra, 128, bw, starts)
                torch.cuda.synchronize()
                bad = (out != ref).sum().item()
                if bad or out.dtype != dtype or not torch.equal(out, again):
                    raise PhaseError(f"maxpool C={c} {mode} {dtype}: {bad} mismatches, same bits on two launches: "
                                     f"{torch.equal(out, again)}")
                if dtype == torch.float32:
                    k32_ms = time_ms(lambda: banded_maxpool_fused(f, q, s, ra, 128, bw, starts))
            k_ms = time_ms(lambda: banded_maxpool_fused(f, q, s, ra, 128, bw, starts))
            p_ms = time_ms(lambda: banded_maxpool_plain(f, q, s, ra, 128, bw, starts), 3)
            m, n = q.shape[1], s.shape[1]
            bd = call_bound("banded_maxpool_fused", (f, q, s, ra, 128, bw, starts))
            tally.add("maxpool", 0.0, k_ms, p_ms, bd)
            say("kernels", f"maxpool C={c} lvl{ql}<-lvl{sl} {mode} B={b} M={m} N={n}: 0 mismatches fp32+bf16, the "
                f"same bits on two launches; bf16 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms "
                f"({bd[1]}); fp32 kernel {k32_ms:.3f} ms")

    # --- C: attention ----------------------------------------------------
    # serving's sequence-normalised queries (logits near 0, a near-uniform
    # softmax, outputs ~0.03) and plain randn ones (logit std ~1), where a
    # kernel that dropped Q K^T, the 1/sqrt(D) or P V would err by > 4e-3:
    # fp32 abs <= 1e-5, bf16 abs <= 2e-2 against fp32 plain, and each bf16
    # output within bf16's rounding of the fp32 plain version on the same
    # bf16 inputs plus ATTN_BF16_EXCESS
    for queries in ("randn", "normalised"):
        q, k, v = (torch.randn(b, 1280, 4, 32, generator=gen).to(device) for _ in range(3))
        if queries == "normalised":
            q = q / q.norm(dim=1, keepdim=True)
        ref = fused_attention_plain(q, k, v)
        e32 = (fused_attention(q, k, v) - ref).abs().max().item()
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        out16 = fused_attention(qb, kb, vb)
        torch.cuda.synchronize()
        e16 = (out16.float() - ref).abs().max().item()
        excess = bf16_excess(out16, full_attention(qb, kb, vb))
        if e32 > 1e-5 or e16 > 2e-2 or excess > ATTN_BF16_EXCESS or out16.dtype != torch.bfloat16:
            raise PhaseError(f"attention, {queries} q: fp32 abs {e32:.2e} (<=1e-5), bf16 abs {e16:.2e} (<=2e-2), "
                             f"bf16 beyond its rounding {excess:.2e} (<={ATTN_BF16_EXCESS:.0e}), dtype {out16.dtype}")
        say("kernels", f"attention (8,1280,4,32), {queries} q: fp32 abs {e32:.2e}, bf16 abs {e16:.2e}, bf16 beyond "
            f"its rounding of the fp32 plain version on the bf16 inputs {excess:.2e}, out bf16")
    # fp32 (the `.t7` path's, 3xTF32) on the same normalised queries, with
    # the library's fp32 attention as its yardstick
    a32_ms = time_ms(lambda: fused_attention(q, k, v))
    q32, k32, v32 = (x.transpose(1, 2) for x in (q, k, v))
    a32_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q32, k32, v32))
    bd32 = call_bound("fused_attention", (q, k, v))
    say("kernels", f"attention (8,1280,4,32), normalised q, fp32 (3xTF32): kernel {a32_ms:.3f} ms, "
        f"scaled_dot_product_attention {a32_lib:.3f} ms, bound {bd32[0]:.3f} ms ({bd32[1]})")
    # timed on serving's queries
    e16_same = (out16.float() - fused_attention_plain(qb, kb, vb).float()).abs().max().item()
    c_ms = time_ms(lambda: fused_attention(qb, kb, vb))
    c_plain = time_ms(lambda: fused_attention_plain(qb, kb, vb))
    # the library's fused attention on the same inputs, timed as a yardstick only
    qh, kh, vh = (x.transpose(1, 2) for x in (qb, kb, vb))
    c_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
    bd = call_bound("fused_attention", (qb, kb, vb))
    # the timed kernel (bf16, tensor cores) against the plain version on its inputs
    tally.add("attention", e16_same, c_ms, c_plain, bd, library_ms=c_lib)
    say("kernels", f"attention (8,1280,4,32), normalised q: bf16 abs {e16_same:.2e} vs the plain version on "
        f"the bf16 inputs; bf16 kernel {c_ms:.3f} ms, plain {c_plain:.3f} ms, scaled_dot_product_attention "
        f"{c_lib:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")

    check_training_kernels(device, gen, tally, cfg)
    check_knn_kernels(device, gen, tally, cfg)
    check_window_and_tau_backward_kernels(device, gen, tally, cfg)
    check_residual_kernel(device, gen, tally, cfg)
    check_kernel_sizes(device, cfg)
    check_point_norm(device, tally)
    check_window_starts(device, tally)


def point_norm_gaps(x, weight, bias, num_groups, eps=1e-5, relu=False, residual=None):
    """#18 on one call's inputs against the plain version: the statistics'
    worst gaps (the mean's over the group's scale |mean| + 1 / rstd, rstd's
    relative), whether two statistics launches give the same bits, and
    the elements where the apply kernel on the plain statistics differs
    from the plain apply on them."""
    import torch

    from cofii2p_tpu_torch.ops import norm_kernel as nk

    mp, rp = nk.group_norm_stats_plain(x, num_groups, eps)
    mk, rk = nk.point_norm_stats(x, num_groups, eps)
    mk2, rk2 = nk.point_norm_stats(x, num_groups, eps)
    out = nk.point_norm_apply(x, mp, rp, weight, bias, relu, residual)
    ref = nk.group_norm_apply_plain(x, mp, rp, weight, bias, relu, residual)
    mean_gap = ((mk - mp).abs() / (mp.abs() + 1 / rp)).max().item()
    rstd_gap = ((rk - rp).abs() / rp).max().item()
    same = torch.equal(mk, mk2) and torch.equal(rk, rk2)
    return mean_gap, rstd_gap, same, int((out != ref).sum())


def check_point_norm(device, tally):
    """#18 on the group-norm calls of one bf16 B=8 serving forward, each
    on its recorded inputs: the statistics within 1e-5 of the plain
    version's and the same bits on two launches, the apply bit-equal to
    the plain apply on the plain statistics; then the calls through the
    kernels and through the plain version, each set replayed as one CUDA
    graph as a serving request runs it (device time, not the host's pace
    of 141 small launches), beside the chain's own bytes at 3.35 TB/s
    (kernel_bench.call_work: x and the residual read once, the output
    written once; the kernels read x a second time, their design's cost)."""
    import inspect

    import torch

    from cofii2p_tpu_torch.utils.kernel_bench import call_bound, graphed, kernel_wrappers, record_serve, time_ms

    _, kern, plain = kernel_wrappers()["point_group_norm_fused"]
    calls = [c for c in record_serve(BATCH, 0, device) if c[0] == "point_group_norm_fused"]
    if len(calls) != NORM_SITES:
        raise PhaseError(f"point_norm: {len(calls)} group-norm calls in a serving forward, expected {NORM_SITES}")
    b_ms = worst = 0.0
    args = []
    with torch.no_grad():  # the recorded weights are the model's parameters
        for name, a, kw in calls:
            arg = inspect.signature(kern).bind(*a, **kw)
            arg.apply_defaults()
            arg = dict(arg.arguments)
            args.append(arg)
            mean_gap, rstd_gap, same, bad = point_norm_gaps(**arg)
            if max(mean_gap, rstd_gap) > 1e-5 or not same or bad:
                raise PhaseError(f"point_norm x {tuple(arg['x'].shape)}: mean gap {mean_gap:.2e}, rstd gap "
                                 f"{rstd_gap:.2e} (<= 1e-5), the same bits on two launches {same}, apply "
                                 f"mismatches {bad}")
            worst = max(worst, mean_gap, rstd_gap)
            b_ms += call_bound(name, a, kw)[0]
        k_ms = time_ms(graphed(lambda: [kern(**arg) for arg in args]).replay)
        p_ms = time_ms(graphed(lambda: [plain(**arg) for arg in args]).replay, 3)
    tally.add("point_norm", worst, k_ms, p_ms, (b_ms, "bytes"))
    say("kernels", f"point_norm: the {len(calls)} group norms of a bf16 B={BATCH} serving forward on their own "
        f"inputs: statistics within {worst:.2e} of the plain version's, the same bits on two launches, the apply "
        f"bit-equal on the plain statistics; kernels {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
        "(bytes at 3.35 TB/s)")


def check_window_starts(device, tally):
    """#19 on the window placements of one bf16 B=8 serving forward, each on
    its recorded inputs: the starts bit-equal to the plain version's and the
    same on two launches; then the calls through the kernel and through the
    plain version, each set replayed as one CUDA graph as a serving request
    runs it, beside the bound (kernel_bench.call_work: the points read
    once, 9 fp32 operations a (query, sampled row) pair at 67 TFLOP/s)."""
    import torch

    from cofii2p_tpu_torch.utils.kernel_bench import (_describe, call_bound, graphed, kernel_wrappers, record_serve,
                                                      time_ms)

    _, kern, plain = kernel_wrappers()["best_windows_fused"]
    calls = [c for c in record_serve(BATCH, 0, device) if c[0] == "best_windows_fused"]
    if len(calls) != WINDOW_PAIRS:
        raise PhaseError(f"window_starts: {len(calls)} placements in a serving forward, expected {WINDOW_PAIRS}")
    b_ms, shapes = 0.0, []
    for name, a, kw in calls:
        got, again, want = kern(*a, **kw), kern(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(got, again):
            raise PhaseError(f"window_starts {_describe(name, a, kw)}: {(got != want).sum().item()} starts differ "
                             f"from the plain version's, the same on two launches {torch.equal(got, again)}")
        b_ms += call_bound(name, a, kw)[0]
        shapes.append(f"{_describe(name, a, kw)} {tuple(got.shape)}")
    k_ms = time_ms(graphed(lambda: [kern(*a, **kw) for _, a, kw in calls]).replay)
    p_ms = time_ms(graphed(lambda: [plain(*a, **kw) for _, a, kw in calls]).replay, 3)
    tally.add("window_starts", 0.0, k_ms, p_ms, (b_ms, "operations"))
    say("kernels", f"window_starts: the {len(calls)} placements of a bf16 B={BATCH} serving forward ("
        + "; ".join(shapes) + f") on their own inputs: starts bit-equal to the plain version's, the same on two "
        f"launches; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms (both as one CUDA graph each)")


def check_training_kernels(device, gen, tally, cfg):
    """The four kernels of the training backward path against their plain
    versions, fp32, B=8, at the trainer's shapes; the aggregate (#2) and the
    transpose (#9) also on encoder4_2's 2176-row band, where the CUDA-core
    templates they replaced redid their membership for every kernel point;
    #9 at C = 512 in two channel blocks, and the same bits on two launches;
    the tie count (#12) and the maxpool backward (#13) at the four strided
    shortcuts, in bf16 too at C = 256: counts bit-equal, #13 rel <= 1e-5,
    both the same bits on two launches."""
    import torch

    from cofii2p_tpu_torch.ops.banded import kernel_reach
    from cofii2p_tpu_torch.ops.kpconv_kernel import (
        banded_kpconv_aggregate_fused,
        banded_kpconv_aggregate_plain,
        banded_kpconv_transpose_fused,
        banded_kpconv_transpose_plain,
    )
    from cofii2p_tpu_torch.ops.maxpool_kernel import (
        banded_maxpool_backward_fused,
        banded_maxpool_fused,
        banded_maxpool_route_plain,
        banded_maxpool_tie_count_fused,
        banded_maxpool_tie_count_plain,
    )
    from cofii2p_tpu_torch.utils.kernel_bench import call_bound, time_ms

    b, r0, s0, plan = BATCH, cfg.init_radius, cfg.init_sigma, cfg.kpconv_band_plan
    sizes = cfg.pyramid_sizes
    levels, idents = pyramid_with_duplicates(sizes, b, gen, device)

    # --- #2 aggregate and #9 transposed aggregate -----------------------------
    cases = [("lvl0 C32 band 128", 0, 0, 32, r0, s0, plan[0]),
             ("lvl1<-lvl0 strided C32", 1, 0, 32, r0, s0, plan[0]),
             ("lvl3 C256 band 2176", 3, 3, 256, r0 * 8, s0 * 8, plan[3]),
             ("lvl4 C512 full band", 4, 4, 512, r0 * 16, s0 * 16, plan[4])]
    # the 2176-row case draws from a generator of its own, so that every
    # check after it keeps the inputs it is gated on
    own_gen = {"lvl3 C256 band 2176": torch.Generator().manual_seed(3)}
    for name, ql, sl, c, r, sg, bw in cases:
        q, s = levels[ql], levels[sl]
        m, n = q.shape[1], s.shape[1]
        cgen = own_gen.get(name, gen)
        f = torch.randn(b, n, c, generator=cgen).to(device)
        ref, ref_cnt = banded_kpconv_aggregate_plain(f, q, s, r, sg, 15, 128, bw)
        out, cnt = banded_kpconv_aggregate_fused(f, q, s, r, sg, 15, 128, bw)
        torch.cuda.synchronize()
        e2 = rel_err(out, ref)
        if not torch.equal(cnt, ref_cnt) or e2 > 1e-3:
            raise PhaseError(f"kpconv_aggregate {name}: counts differ at {(cnt != ref_cnt).sum().item()} "
                             f"queries, rel err {e2:.3e} (<= 1e-3)")
        k_ms = time_ms(lambda: banded_kpconv_aggregate_fused(f, q, s, r, sg, 15, 128, bw))
        p_ms = time_ms(lambda: banded_kpconv_aggregate_plain(f, q, s, r, sg, 15, 128, bw), 3)
        bd = call_bound("banded_kpconv_aggregate_fused", (f, q, s, r, sg, 15, 128, bw))
        tally.add("kpconv_aggregate", (out - ref).abs().max().item(), k_ms, p_ms, bd)
        say("kernels", f"kpconv_aggregate {name} B={b} M={m} N={n}: counts equal, rel {e2:.2e}; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del out, ref
        g = torch.randn(b, m, 15, c, generator=cgen).to(device)
        ref = banded_kpconv_transpose_plain(g, q, s, r, sg, 15, 128, bw)
        out = banded_kpconv_transpose_fused(g, q, s, r, sg, 15, 128, bw)
        out2 = banded_kpconv_transpose_fused(g, q, s, r, sg, 15, 128, bw)
        torch.cuda.synchronize()
        e9 = rel_err(out, ref)
        if e9 > 1e-4 or not torch.equal(out, out2):
            raise PhaseError(f"kpconv_transpose {name}: rel err {e9:.3e} (<= 1e-4), the same bits on two "
                             f"launches {torch.equal(out, out2)}")
        k_ms = time_ms(lambda: banded_kpconv_transpose_fused(g, q, s, r, sg, 15, 128, bw))
        p_ms = time_ms(lambda: banded_kpconv_transpose_plain(g, q, s, r, sg, 15, 128, bw), 3)
        bd = call_bound("banded_kpconv_transpose_fused", (g, q, s, r, sg, 15, 128, bw))
        tally.add("kpconv_transpose", (out - ref).abs().max().item(), k_ms, p_ms, bd)
        say("kernels", f"kpconv_transpose {name} B={b} M={m} N={n}: rel {e9:.2e}, the same bits on two "
            f"launches; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del g, out, out2, ref

    # --- #12 tie count and #13 maxpool backward, with tied maxima -------------
    # both at the four strided shortcuts (C = 128 .. 1024 on their levels),
    # fp32, and in bf16 at C = 256; the C = 256 and 512 cases draw from
    # generators of their own
    for c, ql, sl, fgen in ((128, 1, 0, gen), (256, 2, 1, torch.Generator().manual_seed(8)),
                            (512, 3, 2, torch.Generator().manual_seed(9)), (1024, 4, 3, gen)):
        q, s = levels[ql], levels[sl]
        m, n = q.shape[1], s.shape[1]
        r, sg, bw = r0 * 2 ** sl, s0 * 2 ** sl, plan[sl]
        ra = kernel_reach(r, sg)
        base = torch.randn(b, sizes[0], c, generator=fgen).to(device)
        f = torch.gather(base, 1, idents[sl][..., None].expand(-1, -1, c))  # duplicated points tie
        # bf16 first, so that the fp32 case's out and counts are kept
        pooled = {}
        for dtype in (torch.bfloat16, torch.float32) if c == 256 else (torch.float32,):
            fd = f.to(dtype)
            out = banded_maxpool_fused(fd, q, s, ra, 128, bw)
            ref = banded_maxpool_tie_count_plain(fd, q, s, out, ra, 128, bw)
            cnt = banded_maxpool_tie_count_fused(fd, q, s, out, ra, 128, bw)
            again = banded_maxpool_tie_count_fused(fd, q, s, out, ra, 128, bw)
            torch.cuda.synchronize()
            if not torch.equal(cnt, ref) or not torch.equal(cnt, again):
                raise PhaseError(f"maxpool_count C={c} {dtype}: {(cnt != ref).sum().item()} counts differ, the "
                                 f"same bits on two launches {torch.equal(cnt, again)}")
            ties = int((cnt > 1).sum())
            if ties == 0:
                raise PhaseError(f"maxpool_count C={c} {dtype}: no tied maximum in a cloud with duplicated points")
            pooled[dtype] = (fd, out, cnt)
        k_ms = time_ms(lambda: banded_maxpool_tie_count_fused(f, q, s, out, ra, 128, bw))
        p_ms = time_ms(lambda: banded_maxpool_tie_count_plain(f, q, s, out, ra, 128, bw), 3)
        bd = call_bound("banded_maxpool_tie_count_fused", (f, q, s, out, ra, 128, bw))
        tally.add("maxpool_count", 0.0, k_ms, p_ms, bd)
        say("kernels", f"maxpool_count C={c} lvl{ql}<-lvl{sl} B={b} M={m} N={n}: counts equal"
            f"{' fp32+bf16' if c == 256 else ''}, the same bits on two launches, {ties} tied (query, channel) "
            f"maxima; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        # #13 on the same out and counts, bf16 first where there is one
        g = torch.randn(b, m, c, generator=gen if c in (128, 1024) else fgen).to(device)
        for dtype, (fd, out, cnt) in pooled.items():
            gs = g / torch.clamp(cnt, min=1.0)
            ref = banded_maxpool_route_plain(gs, fd, q, s, out, ra, 128, bw)
            got = banded_maxpool_backward_fused(gs, fd, q, s, out, ra, 128, bw)
            again = banded_maxpool_backward_fused(gs, fd, q, s, out, ra, 128, bw)
            torch.cuda.synchronize()
            e13 = rel_err(got, ref)
            if e13 > 1e-5 or not torch.equal(got, again):
                raise PhaseError(f"maxpool_bwd C={c} {dtype}: rel err {e13:.3e} (<= 1e-5), the same bits on two "
                                 f"launches {torch.equal(got, again)}")
            if dtype == torch.bfloat16:
                say("kernels", f"maxpool_bwd C={c} bf16 B={b} M={m} N={n}: rel {e13:.2e}, the same bits on two "
                    "launches")
                continue
            k_ms = time_ms(lambda: banded_maxpool_backward_fused(gs, fd, q, s, out, ra, 128, bw))
            p_ms = time_ms(lambda: banded_maxpool_route_plain(gs, fd, q, s, out, ra, 128, bw), 3)
            bd = call_bound("banded_maxpool_backward_fused", (gs, fd, q, s, out, ra, 128, bw))
            tally.add("maxpool_bwd", (got - ref).abs().max().item(), k_ms, p_ms, bd)
            say("kernels", f"maxpool_bwd C={c} lvl{ql}<-lvl{sl} B={b} M={m} N={n}: rel {e13:.2e}, the same bits "
                f"on two launches; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del base, f, fd, out, ref, cnt, again, g, gs, got, pooled


def check_knn_kernels(device, gen, tally, cfg):
    """The four kernels of the `.t7` path against their plain versions at
    its fp32 shapes, B=8, on clouds with duplicated points: tau on every
    (query level, support level) pair of the FPN, bit-equal (its
    library_ms is torch.topk over the same (tile, band) d2 blocks), also on
    w256 windows and with kk = band, the same bits on two launches; the tau
    KPConvs with per-layer kernel points and features of both signs, equal
    active-row counts, fp32 rel <= 1e-4 and bf16 rel <= 5e-2 (kernel #1's),
    at every width of the FPN (#6 at Cin 512, where the FPN takes it, and
    at lvl0's Cin 32, banded_knn training's largest write) and on bands of
    over 2048 rows (encoder4_2's 2176, encoder5_1's 2304); the tau maxpool
    bit-equal in fp32 and bf16."""
    import torch

    from cofii2p_tpu_torch.ops.banded import (
        _load_kernel_points,
        _membership_d2,
        _tiles,
        band_plan,
        dynamic_knn_starts,
    )
    from cofii2p_tpu_torch.ops.kpconv_kernel import (
        banded_kpconv_aggregate_tau,
        banded_kpconv_aggregate_tau_plain,
        banded_kpconv_fused_tau,
        banded_kpconv_fused_tau_plain,
    )
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_tau, banded_maxpool_tau_plain
    from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_kernel, banded_knn_tau_plain
    from cofii2p_tpu_torch.utils.convert import jittered_kernel_points
    from cofii2p_tpu_torch.utils.kernel_bench import call_bound, time_ms

    b, r0, s0, plan, k = BATCH, cfg.init_radius, cfg.init_sigma, cfg.kpconv_band_plan, cfg.neighbor_num
    levels, idents = pyramid_with_duplicates(cfg.pyramid_sizes, b, gen, device)

    # --- #5 tau: the 5 self and 4 cross pairs of one forward ---------------
    taus = {}
    for ql, sl in [(lvl, lvl) for lvl in range(5)] + [(lvl, lvl - 1) for lvl in range(1, 5)]:
        q, s, bw = levels[ql], levels[sl], plan[sl]
        ref = banded_knn_tau_plain(q, s, k, 128, bw)
        got = banded_knn_tau_kernel(q, s, k, 128, bw)
        torch.cuda.synchronize()
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        if bad:
            raise PhaseError(f"knn_tau lvl{ql}<-lvl{sl}: {bad} of {ref.numel()} thresholds differ in their bits")
        tile, nt, band = band_plan(q.shape[1], s.shape[1], 128, bw)
        qt, pb, _ = _tiles(q, s, None, tile, nt, band, None)
        d2 = _membership_d2(qt, pb)
        # queries whose k-th and (k+1)-th distances tie: more than k members
        ties = int(((d2 <= ref.reshape(b, nt, tile, 1)).sum(-1) > min(k, band)).sum())
        k_ms = time_ms(lambda: banded_knn_tau_kernel(q, s, k, 128, bw))
        p_ms = time_ms(lambda: banded_knn_tau_plain(q, s, k, 128, bw), 3)
        l_ms = time_ms(lambda: torch.topk(d2, min(k + 1, band), dim=-1, largest=False))
        bd = call_bound("banded_knn_tau_kernel", (q, s, k, 128, bw))
        tally.add("knn_tau", 0.0, k_ms, p_ms, bd, library_ms=l_ms)
        taus[(ql, sl)] = ref
        say("kernels", f"knn_tau lvl{ql}<-lvl{sl} B={b} M={q.shape[1]} band {band} k={k}: bit-equal, "
            f"{ties} queries with tied k-th/(k+1)-th distances; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"torch.topk {l_ms:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
        del d2, qt, pb
    # beside the 9 pairs: tau over w256 windows (lvl1 <- lvl0, placed by
    # dynamic_knn_starts) and with kk = band (a 128-row level: no (k+1)-th
    # row), bit-equal; not in the tally, whose sums are the forward's 9 calls
    q, s = levels[1], levels[0]
    starts = dynamic_knn_starts(q, s, taus[(1, 0)], 128, 256, 1)
    lone = levels[4][:, :128].contiguous()
    for name, args in (("w256 windows lvl1<-lvl0", (q, s, k, 128, 256, starts)),
                       ("kk = band = 128", (lone, lone, k, 128, 64))):
        ref = banded_knn_tau_plain(*args)
        got = banded_knn_tau_kernel(*args)
        again = banded_knn_tau_kernel(*args)
        torch.cuda.synchronize()
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        if bad or not torch.equal(got, again):
            raise PhaseError(f"knn_tau {name}: {bad} of {ref.numel()} thresholds differ in their bits, the same "
                             f"bits on two launches {torch.equal(got, again)}")
        say("kernels", f"knn_tau {name} B={b} M={args[0].shape[1]}: bit-equal, the same bits on two launches; "
            f"kernel {time_ms(lambda: banded_knn_tau_kernel(*args)):.3f} ms")
    del q, s, starts, lone, ref, got, again

    # --- #7 fused and #6 aggregate tau KPConvs -------------------------------
    kgen = torch.Generator().manual_seed(1)
    cases = [("enc1_1 lvl0 C4->64", 0, 0, 4, 64, r0, s0), ("enc1_2 lvl0 C32", 0, 0, 32, 32, r0, s0),
             ("enc2_2 lvl1 C64", 1, 1, 64, 64, r0 * 2, s0 * 2), ("enc3_2 lvl2 C128", 2, 2, 128, 128, r0 * 4, s0 * 4),
             ("enc4_2 lvl3 C256 (two segments)", 3, 3, 256, 256, r0 * 8, s0 * 8),
             ("enc5_1 lvl4<-lvl3 C256 (two segments)", 4, 3, 256, 256, r0 * 8, s0 * 8),
             ("enc5_2 lvl4 C512, aggregate", 4, 4, 512, 0, r0 * 16, s0 * 16),
             ("enc1_2 lvl0 C32, aggregate", 0, 0, 32, 0, r0, s0)]
    for name, ql, sl, cin, cout, r, sg in cases:
        q, s, bw, tau = levels[ql], levels[sl], plan[sl], taus[(ql, sl)]
        base = torch.randn(b, levels[0].shape[1], cin, generator=gen).to(device)
        f = torch.gather(base, 1, idents[sl][..., None].expand(-1, -1, cin))  # duplicated points, same rows
        kp = jittered_kernel_points(torch.tensor(_load_kernel_points(r, 15), dtype=torch.float32), kgen).to(device)
        sums = f.sum(-1)
        near0 = int((sums.abs() <= 1e-6 * f.abs().sum(-1)).sum())
        if cout:
            w = (torch.randn(15, cin, cout, generator=gen) / cin**0.5).to(device)
            args = (f, q, s, w, tau, kp, r, sg, 15, 128, bw)
            kern, plain, kname = banded_kpconv_fused_tau, banded_kpconv_fused_tau_plain, "kpconv_fused_tau"
        else:
            args = (f, q, s, tau, kp, r, sg, 15, 128, bw)
            kern, plain, kname = banded_kpconv_aggregate_tau, banded_kpconv_aggregate_tau_plain, "kpconv_aggregate_tau"
        ref, ref_cnt = plain(*args)
        out, cnt = kern(*args)
        torch.cuda.synchronize()
        e32 = rel_err(out, ref)
        if not torch.equal(cnt, ref_cnt) or e32 > 1e-4:
            raise PhaseError(f"{kname} {name}: counts differ at {(cnt != ref_cnt).sum().item()} queries "
                             f"({near0} rows sum to within 1e-6 of 0), fp32 rel err {e32:.3e} (<= 1e-4)")
        # bf16 on bf16 features; at Cin = 4 also on fp32 ones, as encoder1_1 takes them
        e16 = 0.0
        for fb in (f.to(torch.bfloat16), f) if cin == 4 else (f.to(torch.bfloat16),):
            args16 = (fb,) + args[1:] + (torch.bfloat16,)
            out16, cnt16 = kern(*args16)
            cnt16_ref = plain(*args16)[1]
            torch.cuda.synchronize()
            e = rel_err(out16, ref)
            if not torch.equal(cnt16, cnt16_ref) or e > 5e-2:
                raise PhaseError(f"{kname} {name}: bf16 on {fb.dtype} features: counts differ at "
                                 f"{(cnt16 != cnt16_ref).sum().item()} queries, bf16 rel err {e:.3e} (<= 5e-2)")
            e16 = max(e16, e)
        k_ms = time_ms(lambda: kern(*args))
        p_ms = time_ms(lambda: plain(*args), 3)
        bd = call_bound(f"banded_{kname}", args)
        tally.add(kname, (out - ref).abs().max().item(), k_ms, p_ms, bd)
        active = float((sums > 0).float().mean())
        band = band_plan(q.shape[1], s.shape[1], 128, bw)[2]
        say("kernels", f"{kname} {name} B={b} M={q.shape[1]} N={s.shape[1]} band {band}: counts equal (active rows "
            f"{active:.2f}, {near0} sums within 1e-6 of 0), fp32 rel {e32:.2e}, bf16 rel {e16:.2e}; fp32 kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del base, f, fb, out, ref, out16

    # --- #8 tau maxpool, with tied maxima ------------------------------------
    # the four strided shortcuts at their levels and `.t7` bands; the C =
    # 128 and 512 cases draw from generators of their own
    for c, ql, sl, fgen in ((128, 1, 0, torch.Generator().manual_seed(6)), (256, 2, 1, gen),
                            (512, 3, 2, torch.Generator().manual_seed(7)), (1024, 4, 3, gen)):
        q, s, bw, tau = levels[ql], levels[sl], plan[sl], taus[(ql, sl)]
        base = torch.randn(b, levels[0].shape[1], c, generator=fgen).to(device)
        f = torch.gather(base, 1, idents[sl][..., None].expand(-1, -1, c))
        b16_ms = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            fd = f.to(dtype)
            out = banded_maxpool_tau(fd, q, s, tau, 128, bw)
            again = banded_maxpool_tau(fd, q, s, tau, 128, bw)
            ref = banded_maxpool_tau_plain(fd, q, s, tau, 128, bw)
            torch.cuda.synchronize()
            bad = (out != ref).sum().item()
            if bad or out.dtype != dtype or not torch.equal(out, again):
                raise PhaseError(f"maxpool_tau C={c} {dtype}: {bad} mismatches, same bits on two launches: "
                                 f"{torch.equal(out, again)}")
            if dtype == torch.bfloat16:
                b16_ms = time_ms(lambda: banded_maxpool_tau(fd, q, s, tau, 128, bw))
        k_ms = time_ms(lambda: banded_maxpool_tau(f, q, s, tau, 128, bw))
        p_ms = time_ms(lambda: banded_maxpool_tau_plain(f, q, s, tau, 128, bw), 3)
        bd = call_bound("banded_maxpool_tau", (f, q, s, tau, 128, bw))
        tally.add("maxpool_tau", 0.0, k_ms, p_ms, bd)
        band = band_plan(q.shape[1], s.shape[1], 128, bw)[2]
        say("kernels", f"maxpool_tau C={c} lvl{ql}<-lvl{sl} B={b} M={q.shape[1]} N={s.shape[1]} band {band}: 0 "
            f"mismatches fp32+bf16, the same bits on two launches; fp32 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bd[0]:.3f} ms ({bd[1]}); bf16 kernel {b16_ms:.3f} ms")
        del base, f, fd, out, again, ref


def check_window_and_tau_backward_kernels(device, gen, tally, cfg):
    """The backward kernels of `train --fast` and of `banded_knn` training
    against their plain versions, fp32, B=8, on clouds with duplicated
    points: #10 (window transpose) and #14 (window maxpool backward) on the
    w256 windows the trainer places, with #12 on the same windows; #11
    (tau transpose) and #15 (tau maxpool backward) on the k-NN pairs'
    static bands (up to 2304 rows), with #12 by tau and per-layer kernel
    points.  Tie counts bit-equal (on windows and by tau at the four
    strided shortcuts), #10/#11 rel <= 1e-4, #14/#15 rel <= 1e-5 (#14 at
    the three windowed shortcuts of --fast, #15 at the four tau
    shortcuts), #10's and #14's scatter bit-equal to its plain version on
    the kernel's own stack, and #10, #11, #12, #14 and #15 the same bits on
    two launches."""
    import torch

    from cofii2p_tpu_torch.ops.banded import _load_kernel_points, band_plan, dynamic_band_starts, kernel_reach
    from cofii2p_tpu_torch.ops.kpconv_kernel import (
        band_scatter_plain,
        banded_kpconv_transpose_dyn_fused,
        banded_kpconv_transpose_dyn_plain,
        banded_kpconv_transpose_tau_fused,
        banded_kpconv_transpose_tau_plain,
        transpose_dyn_with_stack,
    )
    from cofii2p_tpu_torch.ops.maxpool_kernel import (
        banded_maxpool_backward_dyn_fused,
        banded_maxpool_backward_tau_fused,
        banded_maxpool_fused,
        banded_maxpool_route_dyn_plain,
        banded_maxpool_route_tau_plain,
        banded_maxpool_tau,
        banded_maxpool_tie_count_fused,
        banded_maxpool_tie_count_plain,
        route_dyn_with_stack,
    )
    from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_plain
    from cofii2p_tpu_torch.utils.convert import jittered_kernel_points
    from cofii2p_tpu_torch.utils.kernel_bench import call_bound, time_ms

    b, r0, s0, plan, k = BATCH, cfg.init_radius, cfg.init_sigma, cfg.kpconv_band_plan, cfg.neighbor_num
    w = 256  # config.FAST_DYNAMIC_PLAN
    levels, idents = pyramid_with_duplicates(cfg.pyramid_sizes, b, gen, device)

    def window_starts(q, s, r, sg):
        # as KPConvFPN.starts_for places them
        return dynamic_band_starts(q, s, kernel_reach(r, sg), 128, w, "best", max(1, s.shape[1] // 2560))

    def tied(c, sl, fgen=gen):
        base = torch.randn(b, levels[0].shape[1], c, generator=fgen).to(device)
        return torch.gather(base, 1, idents[sl][..., None].expand(-1, -1, c))

    def timed(name, kern, plain, args, err, what):
        k_ms = time_ms(lambda: kern(*args))
        p_ms = time_ms(lambda: plain(*args), 3)
        bd = call_bound(kern.__name__, args)
        tally.add(name, err, k_ms, p_ms, bd)
        say("kernels", f"{what}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")

    # --- #10 window transpose: encoder3_1, 3_2 and 5_1 of --fast ------------
    for name, ql, sl, c, scale in (("enc3_1 lvl2<-lvl1 C64", 2, 1, 64, 2), ("enc3_2 lvl2 C128", 2, 2, 128, 4),
                                   ("enc5_1 lvl4<-lvl3 C256", 4, 3, 256, 8)):
        q, s = levels[ql], levels[sl]
        r, sg = r0 * scale, s0 * scale
        st = window_starts(q, s, r, sg)
        g = torch.randn(b, q.shape[1], 15, c, generator=gen).to(device)
        args = (g, q, s, st, r, sg, 15, 128, w)
        ref = banded_kpconv_transpose_dyn_plain(*args)
        out = banded_kpconv_transpose_dyn_fused(*args)
        out2, stack = transpose_dyn_with_stack(*args)
        scat = band_scatter_plain(stack, st, s.shape[1])
        torch.cuda.synchronize()
        e10 = rel_err(out, ref)
        if e10 > 1e-4 or not torch.equal(out2, scat) or not torch.equal(out, out2):
            raise PhaseError(f"kpconv_transpose_dyn {name}: rel err {e10:.3e} (<= 1e-4), scatter bit-equal "
                             f"{torch.equal(out2, scat)}, repeatable {torch.equal(out, out2)}")
        mb = stack.numel() * 4 / 2**20
        timed("kpconv_transpose_dyn", banded_kpconv_transpose_dyn_fused, banded_kpconv_transpose_dyn_plain, args,
              (out - ref).abs().max().item(),
              f"kpconv_transpose_dyn {name} w{w} B={b} M={q.shape[1]} N={s.shape[1]}: rel {e10:.2e}, scatter "
              f"bit-equal on the kernel's {mb:.1f} MiB stack")
        del g, ref, out, out2, stack, scat

    # --- #12 on windows: the four shortcuts; #14: encoder3_1, 4_1 and 5_1 -----
    # (the C = 128 and 512 cases draw from generators of their own)
    for c, ql, sl, fgen in ((128, 1, 0, torch.Generator().manual_seed(10)), (256, 2, 1, gen),
                            (512, 3, 2, torch.Generator().manual_seed(11)), (1024, 4, 3, gen)):
        q, s = levels[ql], levels[sl]
        r, sg = r0 * 2 ** sl, s0 * 2 ** sl
        ra = kernel_reach(r, sg)
        st = window_starts(q, s, r, sg)
        f = tied(c, sl, fgen)
        out = banded_maxpool_fused(f, q, s, ra, 128, w, st)
        cargs = (f, q, s, out, ra, 128, w, st)
        ref = banded_maxpool_tie_count_plain(*cargs)
        cnt = banded_maxpool_tie_count_fused(*cargs)
        again = banded_maxpool_tie_count_fused(*cargs)
        torch.cuda.synchronize()
        ties = int((cnt > 1).sum())
        if not torch.equal(cnt, ref) or not torch.equal(cnt, again) or ties == 0:
            raise PhaseError(f"maxpool_count w{w} C={c}: {(cnt != ref).sum().item()} counts differ, {ties} ties, "
                             f"the same bits on two launches {torch.equal(cnt, again)}")
        timed("maxpool_count", banded_maxpool_tie_count_fused, banded_maxpool_tie_count_plain, cargs, 0.0,
              f"maxpool_count on windows C={c} lvl{ql}<-lvl{sl} w{w} B={b} M={q.shape[1]}: counts equal, the same "
              f"bits on two launches, {ties} tied maxima")
        if c == 128:  # encoder2_1 runs on static bands under --fast
            del f, out, ref, cnt, again
            continue
        g = torch.randn(b, q.shape[1], c, generator=gen if c != 512 else fgen).to(device)
        gs = g / torch.clamp(cnt, min=1.0)
        args = (gs, f, q, s, out, st, ra, 128, w)
        ref = banded_maxpool_route_dyn_plain(*args)
        got = banded_maxpool_backward_dyn_fused(*args)
        got2, stack = route_dyn_with_stack(*args)
        got3, stack2 = route_dyn_with_stack(*args)
        scat = band_scatter_plain(stack, st, s.shape[1])
        torch.cuda.synchronize()
        e14 = rel_err(got, ref)
        same = torch.equal(got, got2) and torch.equal(got2, got3) and torch.equal(stack, stack2)
        if e14 > 1e-5 or not torch.equal(got2, scat) or not same:
            raise PhaseError(f"maxpool_bwd_dyn C={c}: rel err {e14:.3e} (<= 1e-5), scatter bit-equal "
                             f"{torch.equal(got2, scat)}, the same bits on two launches {same}")
        mb = stack.numel() * 4 / 2**20
        timed("maxpool_bwd_dyn", banded_maxpool_backward_dyn_fused, banded_maxpool_route_dyn_plain, args,
              (got - ref).abs().max().item(),
              f"maxpool_bwd_dyn C={c} w{w} B={b} M={q.shape[1]} N={s.shape[1]}: rel {e14:.2e}, scatter bit-equal "
              f"on the kernel's {mb:.1f} MiB stack, the same bits on two launches")
        del f, out, ref, cnt, again, g, gs, got, got2, got3, stack, stack2, scat

    # --- #11 tau transpose: encoder1_2, 4_2 (band 2176) and 5_1 (band 2304) ---
    kgen = torch.Generator().manual_seed(2)
    for name, ql, sl, c, scale in (("enc1_2 lvl0 C32", 0, 0, 32, 1), ("enc4_2 lvl3 C256", 3, 3, 256, 8),
                                   ("enc5_1 lvl4<-lvl3 C256", 4, 3, 256, 8)):
        q, s, bw = levels[ql], levels[sl], plan[sl]
        r, sg = r0 * scale, s0 * scale
        tau = banded_knn_tau_plain(q, s, k, 128, bw)
        kp = jittered_kernel_points(torch.tensor(_load_kernel_points(r, 15), dtype=torch.float32), kgen).to(device)
        g = torch.randn(b, q.shape[1], 15, c, generator=gen).to(device)
        args = (g, q, s, tau, kp, r, sg, 15, 128, bw)
        ref = banded_kpconv_transpose_tau_plain(*args)
        out = banded_kpconv_transpose_tau_fused(*args)
        out2 = banded_kpconv_transpose_tau_fused(*args)
        torch.cuda.synchronize()
        e11 = rel_err(out, ref)
        if e11 > 1e-4 or not torch.equal(out, out2):
            raise PhaseError(f"kpconv_transpose_tau {name}: rel err {e11:.3e} (<= 1e-4), the same bits on two "
                             f"launches {torch.equal(out, out2)}")
        band = min(128 * s.shape[1] // q.shape[1] + 2 * bw, s.shape[1])
        timed("kpconv_transpose_tau", banded_kpconv_transpose_tau_fused, banded_kpconv_transpose_tau_plain, args,
              (out - ref).abs().max().item(),
              f"kpconv_transpose_tau {name} band {band} B={b} M={q.shape[1]} N={s.shape[1]}: rel {e11:.2e}, "
              "the same bits on two launches")
        del g, ref, out, out2

    # --- #12 by tau and #15: the four tau shortcuts (encoder5_1 on its
    # 2304-row band); the C = 128 and 512 cases draw from generators of
    # their own
    for c, ql, sl, fgen in ((128, 1, 0, torch.Generator().manual_seed(12)), (256, 2, 1, gen),
                            (512, 3, 2, torch.Generator().manual_seed(13)), (1024, 4, 3, gen)):
        q, s, bw = levels[ql], levels[sl], plan[sl]
        tau = banded_knn_tau_plain(q, s, k, 128, bw)
        f = tied(c, sl, fgen)
        out = banded_maxpool_tau(f, q, s, tau, 128, bw)
        cargs = (f, q, s, out, 0.0, 128, bw, None, tau)
        ref = banded_maxpool_tie_count_plain(*cargs)
        cnt = banded_maxpool_tie_count_fused(*cargs)
        again = banded_maxpool_tie_count_fused(*cargs)
        torch.cuda.synchronize()
        ties = int((cnt > 1).sum())
        if not torch.equal(cnt, ref) or not torch.equal(cnt, again) or ties == 0:
            raise PhaseError(f"maxpool_count tau C={c}: {(cnt != ref).sum().item()} counts differ, {ties} ties, "
                             f"the same bits on two launches {torch.equal(cnt, again)}")
        band = band_plan(q.shape[1], s.shape[1], 128, bw)[2]
        timed("maxpool_count", banded_maxpool_tie_count_fused, banded_maxpool_tie_count_plain, cargs, 0.0,
              f"maxpool_count by tau C={c} lvl{ql}<-lvl{sl} band {band} B={b} M={q.shape[1]}: counts equal, the "
              f"same bits on two launches, {ties} tied maxima")
        gs = torch.randn(b, q.shape[1], c, generator=fgen).to(device) / torch.clamp(cnt, min=1.0)
        args = (gs, f, q, s, out, tau, 128, bw)
        ref = banded_maxpool_route_tau_plain(*args)
        got = banded_maxpool_backward_tau_fused(*args)
        got2 = banded_maxpool_backward_tau_fused(*args)
        torch.cuda.synchronize()
        e15 = rel_err(got, ref)
        if e15 > 1e-5 or not torch.equal(got, got2):
            raise PhaseError(f"maxpool_bwd_tau C={c}: rel err {e15:.3e} (<= 1e-5), the same bits on two launches "
                             f"{torch.equal(got, got2)}")
        timed("maxpool_bwd_tau", banded_maxpool_backward_tau_fused, banded_maxpool_route_tau_plain, args,
              (got - ref).abs().max().item(),
              f"maxpool_bwd_tau C={c} lvl{ql}<-lvl{sl} band {band} B={b} M={q.shape[1]} N={s.shape[1]}: rel "
              f"{e15:.2e}, the same bits on two launches")
        del f, out, ref, cnt, again, gs, got, got2


def check_residual_kernel(device, gen, tally, cfg):
    """Kernel #16 against its plain version and against the pair it fuses
    (#1 then #3, kernel_bench.unfused_pair) on the same inputs, B=8, on
    clouds with duplicated points so that maxima tie: the four strided
    blocks at the serving shapes (bf16; w192 windows on support levels 1-3,
    the static band on level 0) and the three the fp32 static plan fuses.
    Counts equal and shortcuts bit-equal to both; the conv bit-equal to
    #1's, since it is #1's tensor-core kernel at #1's plan in each
    precision (csrc/kpconv_mma.cuh, POOL mode), and within #1's thresholds
    of the plain version (fp32 rel <= 1e-3, bf16 rel <= 5e-2)."""
    import torch

    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN
    from cofii2p_tpu_torch.ops.banded import dynamic_band_starts, kernel_reach
    from cofii2p_tpu_torch.ops.residual_kernel import banded_residual_fused, banded_residual_fused_plain
    from cofii2p_tpu_torch.utils.kernel_bench import call_bound, time_ms, unfused_pair

    b, r0, s0, plan = BATCH, cfg.init_radius, cfg.init_sigma, cfg.kpconv_band_plan
    levels, idents = pyramid_with_duplicates(cfg.pyramid_sizes, b, gen, device)
    cases = [(stage, torch.bfloat16, SERVE_DYNAMIC_PLAN[stage - 2]) for stage in range(2, 6)]
    cases += [(stage, torch.float32, 0) for stage in range(2, 5)]
    for stage, dtype, width in cases:
        ql, sl = stage - 1, stage - 2
        q, s = levels[ql], levels[sl]
        cin = cfg.kpconv_init_dim * 2 ** (stage - 1)
        cmid = cin // 4
        r, sg = r0 * 2**sl, s0 * 2**sl
        starts, bw = None, plan[sl]
        if width:  # as KPConvFPN.starts_for places them
            starts = dynamic_band_starts(q, s, kernel_reach(r, sg), 128, width, "best", max(1, s.shape[1] // 2560))
            bw = width
        rows = idents[sl][..., None]
        fm = torch.gather(torch.randn(b, levels[0].shape[1], cin, generator=gen).to(device), 1,
                          rows.expand(-1, -1, cin)).to(dtype)  # duplicated points tie
        fa = torch.gather(torch.randn(b, levels[0].shape[1], cmid, generator=gen).to(device), 1,
                          rows.expand(-1, -1, cmid)).to(dtype)
        w = (torch.randn(15, cmid, cmid, generator=gen) / cmid**0.5).to(device)
        args = (fm, fa, w, q, s, r, sg, 15, 128, bw, dtype, starts)
        out, cnt, mp = banded_residual_fused(*args)
        ref, ref_cnt, ref_mp = banded_residual_fused_plain(*args)
        p_out, p_cnt, p_mp = unfused_pair(*args)
        torch.cuda.synchronize()
        name = f"enc{stage}_1 lvl{ql}<-lvl{sl} Cin {cin} Cmid {cmid} {'w%d' % width if width else 'band'} {dtype}"
        err, tol = rel_err(out, ref), (5e-2 if dtype == torch.bfloat16 else 1e-3)
        ok = (torch.equal(cnt, ref_cnt) and torch.equal(cnt, p_cnt) and torch.equal(mp, ref_mp)
              and torch.equal(mp, p_mp) and mp.dtype == dtype and torch.equal(out, p_out) and err <= tol)
        if not ok:
            raise PhaseError(f"residual_fused {name}: counts equal to plain {torch.equal(cnt, ref_cnt)} and to #1 "
                             f"{torch.equal(cnt, p_cnt)}; shortcut bit-equal to plain {torch.equal(mp, ref_mp)} and "
                             f"to #3 {torch.equal(mp, p_mp)} ({mp.dtype}); conv bit-equal to #1 "
                             f"{torch.equal(out, p_out)}, rel {err:.3e} vs plain (<= {tol})")
        k_ms = time_ms(lambda: banded_residual_fused(*args))
        p_ms = time_ms(lambda: banded_residual_fused_plain(*args), 3)
        pair_ms = time_ms(lambda: unfused_pair(*args))
        bd = call_bound("banded_residual_fused", args)
        tally.add("residual_fused", (out - ref).abs().max().item(), k_ms, p_ms, bd)
        say("kernels", f"residual_fused {name} B={b} M={q.shape[1]} N={s.shape[1]}: counts equal, shortcut "
            f"bit-equal to plain and #3, conv bit-equal to #1, rel {err:.2e} vs plain; kernel {k_ms:.3f} ms, "
            f"pair #1+#3 {pair_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del fm, fa, out, ref, mp, ref_mp, p_out, p_mp


def check_kernel_sizes(device, cfg):
    """Every KPConv kernel at K = 12 and 20 kernel points, with the port's
    generated dispositions (models/kernel_points.py), on its smallest
    shape of the K = 15 checks, from a generator of its own, at the K = 15
    gates: #1 at lvl0 C32 static (fp32 rel <= 1e-3 and bf16 <= 5e-2 against
    the fp32 plain version, counts equal in both), #2 and #9 at lvl0 C32
    (counts equal, rel <= 1e-3; rel <= 1e-4 and the same bits on two
    launches), #7 and #6 at encoder1_2's lvl0 C32 with jittered kernel
    points and the pair's tau (counts equal, fp32 rel <= 1e-4, bf16 <=
    5e-2), #10 at encoder3_1's w256 windows (rel <= 1e-4, the scatter
    bit-equal on the kernel's stack, the same bits on two launches), #11 at
    lvl0 C32 (rel <= 1e-4, the same bits on two launches) and #16 at
    encoder2_1's bf16 static shape (counts and shortcut equal to plain and
    to #1 + #3, the conv bit-equal to #1, rel <= 5e-2).  Timed, not tallied:
    the summary's sums are the K = 15 paths'."""
    import torch

    from cofii2p_tpu_torch.ops.banded import _load_kernel_points, dynamic_band_starts, kernel_reach
    from cofii2p_tpu_torch.ops.kpconv_kernel import (
        band_scatter_plain,
        banded_kpconv_aggregate_fused,
        banded_kpconv_aggregate_plain,
        banded_kpconv_aggregate_tau,
        banded_kpconv_aggregate_tau_plain,
        banded_kpconv_fused,
        banded_kpconv_fused_plain,
        banded_kpconv_fused_tau,
        banded_kpconv_fused_tau_plain,
        banded_kpconv_transpose_dyn_plain,
        banded_kpconv_transpose_fused,
        banded_kpconv_transpose_plain,
        banded_kpconv_transpose_tau_fused,
        banded_kpconv_transpose_tau_plain,
        transpose_dyn_with_stack,
    )
    from cofii2p_tpu_torch.ops.residual_kernel import banded_residual_fused, banded_residual_fused_plain
    from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_plain
    from cofii2p_tpu_torch.utils.convert import jittered_kernel_points
    from cofii2p_tpu_torch.utils.kernel_bench import time_ms, unfused_pair

    b, r0, s0, plan, kk = BATCH, cfg.init_radius, cfg.init_sigma, cfg.kpconv_band_plan, cfg.neighbor_num
    gen = torch.Generator().manual_seed(20)
    levels, idents = pyramid_with_duplicates(cfg.pyramid_sizes, b, gen, device)
    q0 = levels[0]

    def fail(msg):
        raise PhaseError(f"kernel sizes: {msg}")

    for K in (12, 20):
        lines = []
        # #1, lvl0 C32 static, fp32 and bf16
        f = torch.randn(b, q0.shape[1], 32, generator=gen).to(device)
        w = (torch.randn(K, 32, 32, generator=gen) / 32**0.5).to(device)
        args = (f, q0, q0, w, r0, s0, K, 128, plan[0], torch.float32, None)
        ref, ref_cnt = banded_kpconv_fused_plain(*args)
        out, cnt = banded_kpconv_fused(*args)
        fb = f.to(torch.bfloat16)
        args16 = (fb,) + args[1:-2] + (torch.bfloat16, None)
        out16, cnt16 = banded_kpconv_fused(*args16)
        cnt16_ref = banded_kpconv_fused_plain(*args16)[1]
        torch.cuda.synchronize()
        e32, e16 = rel_err(out, ref), rel_err(out16, ref)
        if not torch.equal(cnt, ref_cnt) or not torch.equal(cnt16, cnt16_ref) or e32 > 1e-3 or e16 > 5e-2:
            fail(f"K={K} kpconv_fused lvl0 C32: counts equal {torch.equal(cnt, ref_cnt)}/"
                 f"{torch.equal(cnt16, cnt16_ref)}, fp32 rel {e32:.3e} (<= 1e-3), bf16 rel {e16:.3e} (<= 5e-2)")
        lines.append(f"#1 fp32 rel {e32:.2e} bf16 rel {e16:.2e} ({time_ms(lambda: banded_kpconv_fused(*args16)):.3f} "
                     f"ms bf16, {time_ms(lambda: banded_kpconv_fused(*args)):.3f} ms fp32)")
        # #2 and #9, lvl0 C32 on the static band
        a2 = (f, q0, q0, r0, s0, K, 128, plan[0])
        ref, ref_cnt = banded_kpconv_aggregate_plain(*a2)
        out, cnt = banded_kpconv_aggregate_fused(*a2)
        torch.cuda.synchronize()
        e2 = rel_err(out, ref)
        if not torch.equal(cnt, ref_cnt) or e2 > 1e-3:
            fail(f"K={K} kpconv_aggregate lvl0 C32: counts equal {torch.equal(cnt, ref_cnt)}, rel {e2:.3e} (<= 1e-3)")
        g = torch.randn(b, q0.shape[1], K, 32, generator=gen).to(device)
        a9 = (g, q0, q0, r0, s0, K, 128, plan[0])
        ref = banded_kpconv_transpose_plain(*a9)
        out, out2 = banded_kpconv_transpose_fused(*a9), banded_kpconv_transpose_fused(*a9)
        torch.cuda.synchronize()
        e9 = rel_err(out, ref)
        if e9 > 1e-4 or not torch.equal(out, out2):
            fail(f"K={K} kpconv_transpose lvl0 C32: rel {e9:.3e} (<= 1e-4), repeatable {torch.equal(out, out2)}")
        lines.append(f"#2 rel {e2:.2e} ({time_ms(lambda: banded_kpconv_aggregate_fused(*a2)):.3f} ms), #9 rel "
                     f"{e9:.2e} ({time_ms(lambda: banded_kpconv_transpose_fused(*a9)):.3f} ms)")
        del ref, out, out2, g
        # #7 and #6 (and #11), encoder1_2 lvl0 C32 under k-NN membership
        tau = banded_knn_tau_plain(q0, q0, kk, 128, plan[0])
        kp = jittered_kernel_points(torch.tensor(_load_kernel_points(r0, K), dtype=torch.float32), gen).to(device)
        ft = torch.gather(torch.randn(b, q0.shape[1], 32, generator=gen).to(device), 1,
                          idents[0][..., None].expand(-1, -1, 32))
        for name, kern, plain, targs in (
                ("kpconv_fused_tau", banded_kpconv_fused_tau, banded_kpconv_fused_tau_plain,
                 (ft, q0, q0, w, tau, kp, r0, s0, K, 128, plan[0])),
                ("kpconv_aggregate_tau", banded_kpconv_aggregate_tau, banded_kpconv_aggregate_tau_plain,
                 (ft, q0, q0, tau, kp, r0, s0, K, 128, plan[0]))):
            ref, ref_cnt = plain(*targs)
            out, cnt = kern(*targs)
            t16 = (ft.to(torch.bfloat16),) + targs[1:] + (torch.bfloat16,)
            out16, cnt16 = kern(*t16)
            cnt16_ref = plain(*t16)[1]
            torch.cuda.synchronize()
            e32, e16 = rel_err(out, ref), rel_err(out16, ref)
            if not torch.equal(cnt, ref_cnt) or not torch.equal(cnt16, cnt16_ref) or e32 > 1e-4 or e16 > 5e-2:
                fail(f"K={K} {name} lvl0 C32: counts equal {torch.equal(cnt, ref_cnt)}/"
                     f"{torch.equal(cnt16, cnt16_ref)}, fp32 rel {e32:.3e} (<= 1e-4), bf16 rel {e16:.3e} (<= 5e-2)")
            lines.append(f"{'#7' if 'fused' in name else '#6'} fp32 rel {e32:.2e} bf16 rel {e16:.2e} "
                         f"({time_ms(lambda: kern(*targs)):.3f} ms)")
        g = torch.randn(b, q0.shape[1], K, 32, generator=gen).to(device)
        a11 = (g, q0, q0, tau, kp, r0, s0, K, 128, plan[0])
        ref = banded_kpconv_transpose_tau_plain(*a11)
        out, out2 = banded_kpconv_transpose_tau_fused(*a11), banded_kpconv_transpose_tau_fused(*a11)
        torch.cuda.synchronize()
        e11 = rel_err(out, ref)
        if e11 > 1e-4 or not torch.equal(out, out2):
            fail(f"K={K} kpconv_transpose_tau lvl0 C32: rel {e11:.3e} (<= 1e-4), repeatable {torch.equal(out, out2)}")
        lines.append(f"#11 rel {e11:.2e} ({time_ms(lambda: banded_kpconv_transpose_tau_fused(*a11)):.3f} ms)")
        del ref, out, out2, g, ft
        # #10, encoder3_1's w256 windows (lvl2 <- lvl1, C64)
        q, s, r, sg = levels[2], levels[1], r0 * 2, s0 * 2
        st = dynamic_band_starts(q, s, kernel_reach(r, sg, K), 128, 256, "best", max(1, s.shape[1] // 2560))
        g = torch.randn(b, q.shape[1], K, 64, generator=gen).to(device)
        a10 = (g, q, s, st, r, sg, K, 128, 256)
        ref = banded_kpconv_transpose_dyn_plain(*a10)
        out, stack = transpose_dyn_with_stack(*a10)
        out2, _ = transpose_dyn_with_stack(*a10)
        scat = band_scatter_plain(stack, st, s.shape[1])
        torch.cuda.synchronize()
        e10 = rel_err(out, ref)
        if e10 > 1e-4 or not torch.equal(out, scat) or not torch.equal(out, out2):
            fail(f"K={K} kpconv_transpose_dyn w256: rel {e10:.3e} (<= 1e-4), scatter bit-equal "
                 f"{torch.equal(out, scat)}, repeatable {torch.equal(out, out2)}")
        lines.append(f"#10 rel {e10:.2e} ({time_ms(lambda: transpose_dyn_with_stack(*a10)):.3f} ms)")
        del ref, out, out2, stack, scat, g
        # #16, encoder2_1's bf16 static shape (Cin 128, Cmid 32)
        q, s = levels[1], levels[0]
        rows = idents[0][..., None]
        fm = torch.gather(torch.randn(b, q0.shape[1], 128, generator=gen).to(device), 1,
                          rows.expand(-1, -1, 128)).to(torch.bfloat16)
        fa = torch.gather(torch.randn(b, q0.shape[1], 32, generator=gen).to(device), 1,
                          rows.expand(-1, -1, 32)).to(torch.bfloat16)
        a16 = (fm, fa, w, q, s, r0, s0, K, 128, plan[0], torch.bfloat16, None)
        out, cnt, mp = banded_residual_fused(*a16)
        ref, ref_cnt, ref_mp = banded_residual_fused_plain(*a16)
        p_out, p_cnt, p_mp = unfused_pair(*a16)
        torch.cuda.synchronize()
        e16 = rel_err(out, ref)
        ok = (torch.equal(cnt, ref_cnt) and torch.equal(cnt, p_cnt) and torch.equal(mp, ref_mp)
              and torch.equal(mp, p_mp) and torch.equal(out, p_out) and e16 <= 5e-2)
        if not ok:
            fail(f"K={K} residual_fused enc2_1 bf16: counts equal to plain {torch.equal(cnt, ref_cnt)} and to #1 "
                 f"{torch.equal(cnt, p_cnt)}, shortcut bit-equal to plain {torch.equal(mp, ref_mp)} and to #3 "
                 f"{torch.equal(mp, p_mp)}, conv bit-equal to #1 {torch.equal(out, p_out)}, rel {e16:.3e} (<= 5e-2)")
        lines.append(f"#16 rel {e16:.2e}, bit-equal to #1 + #3 ({time_ms(lambda: banded_residual_fused(*a16)):.3f} "
                     "ms)")
        del fm, fa, out, ref, mp, ref_mp, p_out, p_mp
        say("kernels", f"K={K} kernel points, B={b}, every gate of K = 15 met: " + "; ".join(lines))


def frames(cfg, count, device, start=0):
    import torch

    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cfg, "val", length=start + count)
    hb = _collate([ds[start + i] for i in range(count)])
    hb.pop("index")
    return {k: torch.as_tensor(v).to(device) for k, v in hb.items()}


def fp32_forward(cfg, device, seed):
    """A B=1 forward of ``cfg`` (fp32, no grad) through the kernels and
    through the plain versions (kpconv_kernel='xla', attention='full'),
    same seeded weights and draws.  Returns the kernels' launches and the
    FPN and transformer outputs' rel errors; fails above 1e-3."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize

    gen = torch.Generator().manual_seed(seed)
    model = randomize(CoFiI2P(cfg), gen).to(device).eval()
    plain = CoFiI2P(cfg.replace(kpconv_kernel="xla", attention="full")).to(device).eval()
    plain.load_state_dict(model.state_dict())
    hb = frames(cfg, 1, device)
    draws = make_draws(cfg, 1, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    with torch.no_grad():
        reset_launches()
        got = model(batch)
        torch.cuda.synchronize()
        launches = read_launches()
        ref = plain(batch)
    torch.cuda.synchronize()
    errs = {f"fpn[{i}]": rel_err(g, r) for i, (g, r) in enumerate(zip(got["pc_features"], ref["pc_features"]))}
    errs["transformer_img"] = rel_err(got["img_mid"], ref["img_mid"])
    errs["transformer_pc"] = rel_err(got["pc_fused"], ref["pc_fused"])
    if max(errs.values()) > 1e-3:
        raise PhaseError(f"fp32 kernels vs plain: {errs}")
    return launches, errs


def check_fp32_path(device, seed):
    """The whole forward at B=1, fp32: kernels vs plain versions."""
    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig

    cfg = KITTIConfig(kpconv_dynamic_plan=SERVE_DYNAMIC_PLAN, kpconv_dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF,
                      attention="pallas")
    _, errs = fp32_forward(cfg, device, seed)
    say("fp32", "B=1 forward, kernels vs plain versions: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def check_grad(device, seed):
    """One fp32 train step at B=1 on a KITTI-scale frame, through the
    kernels (the autograd Functions) and through the plain versions under
    autograd, with the same weights and draws.

    Whole step: the loss terms agree to 1e-4, and every parameter gradient
    to 1e-3 as rms(difference) / rms(gradient); the biases a one-channel
    group norm cancels (zero in exact arithmetic) are divided by the rms of
    the whole gradient instead.  The element-wise worst is printed, not
    gated: the two forwards differ by fp32 rounding, which flips a few
    leaky-ReLU signs and near-tied maxima, and each flip moves single
    gradient elements by O(1e-2) of their tensor (PERF.md, Findings).
    Layer by layer: every KPConv and strided maxpool call of the kernel
    step is replayed on its own inputs through its autograd Function and
    through autograd of its plain version, with one random cotangent:
    feature and weight gradients agree to 1e-4 (KPConv) and 1e-5 (maxpool),
    element-wise.
    """
    import torch

    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.models.kpconv import KPConv, ResidualBlock, norm_cancelled_biases
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize

    cfg = KITTIConfig()
    hb = frames(cfg, 1, device)
    draws = train_lib.make_train_draws(cfg, 1, torch.Generator(device).manual_seed(seed), device)
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed))
    state, cancelled = model.state_dict(), set(norm_cancelled_biases(model))
    results, calls = {}, []

    def record(mod, args):
        calls.append((mod, tuple(a.detach() if torch.is_tensor(a) else a for a in args)))

    torch.cuda.reset_peak_memory_stats()

    for name, kernel in (("kernels", "auto"), ("plain", "xla")):
        model = CoFiI2P(cfg.replace(kpconv_kernel=kernel)).to(device)
        model.load_state_dict(state)
        hooks = [m.register_forward_pre_hook(record) for m in model.modules()
                 if kernel == "auto" and (isinstance(m, KPConv) or (isinstance(m, ResidualBlock) and m.strided))]
        with torch.no_grad():
            batch = train_lib.prepare_batch(cfg, hb, draws)
        reset_launches()
        terms = train_lib.loss_fn(cfg, model, batch)
        terms["loss"].backward()
        torch.cuda.synchronize()
        launches = read_launches()
        for h in hooks:
            h.remove()
        # parameters the losses do not reach (the image score head, the /32
        # ResNet stage) have no gradient, where JAX's would be zeros
        results[name] = ({k: terms[k].detach() for k in train_lib.METRICS},
                         {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                          for n, p in model.named_parameters()}, launches)
        del model, terms, batch
        torch.cuda.empty_cache()
    (lk, gk, launches), (lp, gp, plain_launches) = results["kernels"], results["plain"]
    if any(plain_launches.values()):
        raise PhaseError(f"grad: the plain step launched kernels {plain_launches}")
    for name in ("kpconv_aggregate", "kpconv_transpose", "maxpool", "maxpool_count", "maxpool_bwd"):
        if launches[name] != PER_STEP[name]:
            raise PhaseError(f"grad: {name} launched {launches[name]} times in the step, expected {PER_STEP[name]}")
    if not all(torch.isfinite(g).all() for g in gk.values()):
        raise PhaseError("grad: non-finite gradients through the kernels")
    loss_err = {k: rel_err(lk[k], lp[k]) for k in lk}
    rms_err = grad_rms_errors(gk, gp, cancelled)
    worst = max(rms_err, key=rms_err.get)
    elem = {n: rel_err(gk[n], gp[n]) for n in gp if n not in cancelled}
    worst_elem = max(elem, key=elem.get)
    if max(loss_err.values()) > 1e-4 or rms_err[worst] > 1e-3:
        bad = sorted(rms_err.items(), key=lambda kv: -kv[1])[:5]
        raise PhaseError(f"grad: losses {loss_err} (<= 1e-4), worst gradients {bad} (<= 1e-3)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    try:
        local = check_layer_grads(calls, device)
    except PhaseError as e:
        raise PhaseError(f"grad: {e}") from None
    say("grad", f"B=1 fp32 train step (peak {peak:.1f} GiB), kernels vs plain versions under autograd: losses "
        + ", ".join(f"{k} {float(lk[k]):.4f} (rel {v:.1e})" for k, v in loss_err.items())
        + f"; {len(rms_err)} parameter gradients, worst rms-relative {rms_err[worst]:.2e} ({worst}); "
        f"element-wise worst {elem[worst_elem]:.2e} ({worst_elem}); " + local)


def grad_rms_errors(grads, ref, cancelled):
    """rms(grads - ref) / rms(ref) per tensor; the biases in ``cancelled``
    (zero gradient in exact arithmetic) are divided by the rms of the whole
    reference gradient instead."""
    import torch

    flat = torch.cat([r.flatten().double() for r in ref.values()])
    rms_all = flat.pow(2).mean().sqrt().item()
    errs = {}
    for name, r in ref.items():
        d = (grads[name].double() - r.double()).pow(2).mean().sqrt().item()
        scale = rms_all if name in cancelled else r.double().pow(2).mean().sqrt().item()
        errs[name] = d / max(scale, 1e-30)
    return errs


def check_layer_grads(calls, device, expect=(14, 4)):
    """Each recorded KPConv and strided-maxpool call of a kernel step,
    replayed through its autograd Function and through autograd of its
    plain version on the same inputs (its dynamic starts or its tau and the
    layer's kernel points included) with one random cotangent; ``expect``
    is the number of (KPConv, maxpool) calls."""
    import torch

    from cofii2p_tpu_torch.models.kpconv import KPConv
    from cofii2p_tpu_torch.ops.kpconv_kernel import (
        banded_kpconv_apply,
        banded_kpconv_fused_plain,
        banded_kpconv_fused_tau_plain,
        banded_kpconv_tau_apply,
    )
    from cofii2p_tpu_torch.ops.maxpool_kernel import (
        banded_maxpool_apply,
        banded_maxpool_plain,
        banded_maxpool_tau_apply,
        banded_maxpool_tau_plain,
    )

    gen = torch.Generator(device).manual_seed(0)
    worst_kp, worst_mp, n_kp, n_mp = 0.0, 0.0, 0, 0
    while calls:
        mod, (s_feats, q, s, starts, tau) = calls.pop(0)
        grads, g = [], None
        if isinstance(mod, KPConv):
            fns = ((banded_kpconv_apply, banded_kpconv_fused_plain) if tau is None else
                   (banded_kpconv_tau_apply, banded_kpconv_fused_tau_plain))
            for fn in fns:
                f = s_feats.clone().requires_grad_()
                w = mod.weights.detach().clone().requires_grad_()
                geo = (mod.radius, mod.sigma, mod.kernel_size, mod.tile, mod.band_width, mod.dtype)
                if tau is None:
                    out, _ = fn(f, q, s, w, *geo, starts)
                else:
                    out, _ = fn(f, q, s, w, tau, mod.kernel_points, *geo)
                g = torch.randn(out.shape, generator=gen, device=device) if g is None else g
                out.backward(g)
                grads.append((f.grad, w.grad))
                del out, f, w
            e = max(rel_err(grads[0][0], grads[1][0]), rel_err(grads[0][1], grads[1][1]))
            worst_kp, n_kp = max(worst_kp, e), n_kp + 1
            if e > 1e-4:
                raise PhaseError(f"KPConv M={q.shape[1]} N={s.shape[1]} C={s_feats.shape[-1]}: "
                                 f"feature/weight gradient rel {e:.2e} > 1e-4 against the plain version")
        else:
            fns = ((banded_maxpool_apply, banded_maxpool_plain) if tau is None else
                   (banded_maxpool_tau_apply, banded_maxpool_tau_plain))
            for fn in fns:
                f = s_feats.clone().requires_grad_()
                if tau is None:
                    out = fn(f, q, s, mod.r_active, mod.tile, mod.band_width, starts)
                else:
                    out = fn(f, q, s, tau, mod.tile, mod.band_width)
                g = torch.randn(out.shape, generator=gen, device=device) if g is None else g
                out.backward(g)
                grads.append(f.grad)
                del out, f
            e = rel_err(grads[0], grads[1])
            worst_mp, n_mp = max(worst_mp, e), n_mp + 1
            if e > 1e-5:
                raise PhaseError(f"maxpool M={q.shape[1]} C={s_feats.shape[-1]}: gradient rel {e:.2e} > 1e-5")
        del grads, g, s_feats
        torch.cuda.empty_cache()
    if (n_kp, n_mp) != expect:
        raise PhaseError(f"replayed {n_kp} KPConv and {n_mp} maxpool calls, expected {expect[0]} and {expect[1]}")
    return (f"layer by layer on the step's own inputs: {n_kp} KPConvs worst rel {worst_kp:.2e} (<= 1e-4), "
            f"{n_mp} maxpools worst rel {worst_mp:.2e} (<= 1e-5)")


def replay_step_layers(cfg, device, seed, windows_only):
    """One B=1 fp32 step of ``cfg`` through the kernels (kernel_bench's
    seeded model: per-layer kernel points under banded_knn); its KPConv and
    strided-maxpool calls, those on dynamic windows only where
    ``windows_only``, replayed by :func:`check_layer_grads`."""
    import torch

    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.models.kpconv import KPConv, ResidualBlock
    from cofii2p_tpu_torch.utils.kernel_bench import train_model

    model = train_model(cfg, seed, device)
    hb = frames(cfg, 1, device)
    draws = train_lib.make_train_draws(cfg, 1, torch.Generator(device).manual_seed(seed), device)
    calls = []

    def record(mod, args):
        if not windows_only or args[3] is not None:
            calls.append((mod, tuple(a.detach() if torch.is_tensor(a) else a for a in args)))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, KPConv) or (isinstance(m, ResidualBlock) and m.strided)]
    with torch.no_grad():
        batch = train_lib.prepare_batch(cfg, hb, draws)
    train_lib.loss_fn(cfg, model, batch)["loss"].backward()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    del model, batch
    torch.cuda.empty_cache()
    expect = (7, 3) if windows_only else (14, 4)
    return check_layer_grads(calls, device, expect)


@contextlib.contextmanager
def recording_train_steps(steps, captured):
    """train.main's steps timed: train_lib.make_train_step patched so that
    each step syncs the device before and after and appends (seconds,
    launches, metrics, end time) to ``steps``; ``captured`` gets the model,
    the config, has_normals and the parameters before the first step."""
    import torch

    from cofii2p_tpu_torch import train_lib

    make_step = train_lib.make_train_step

    def recording_make_train_step(cfg, model, optimizer, has_normals=True, mesh=None):
        captured["model"], captured["cfg"], captured["has_normals"] = model, cfg, has_normals
        captured["before"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_step(cfg, model, optimizer, has_normals, mesh)

        def timed_step(host_batch, draws):
            torch.cuda.synchronize()
            before = read_launches()
            t0 = time.perf_counter()
            metrics = step(host_batch, draws)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            per_step = {k: v - before[k] for k, v in read_launches().items()}
            steps.append((t1 - t0, per_step, {k: float(v) for k, v in metrics.items()}, t1))
            return metrics

        return timed_step

    train_lib.make_train_step = recording_make_train_step
    try:
        yield
    finally:
        train_lib.make_train_step = make_step


@contextlib.contextmanager
def recording_eval_batches(batches, workdir):
    """eval_all.main's batches timed, run from ``workdir`` (the error
    arrays go to the working directory): eval_all.make_eval_body patched
    so that each batch syncs the device before and after and appends
    (seconds, launches, outputs, frames, end time) to ``batches``."""
    import torch

    from cofii2p_tpu_torch.evaluation import eval_all

    make_body = eval_all.make_eval_body

    def recording_make_eval_body(cfg_, model, has_normals=True):
        run = make_body(cfg_, model, has_normals)

        def timed(hb, generator=None, draws=None):
            torch.cuda.synchronize()
            before = read_launches()
            t0 = time.perf_counter()
            out = run(hb, generator, draws)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            per = {k: v - before[k] for k, v in read_launches().items()}
            batches.append((t1 - t0, per, out, hb["pc"].shape[0], t1))
            return out

        return timed

    cwd = os.getcwd()
    eval_all.make_eval_body = recording_make_eval_body
    try:
        os.chdir(workdir)
        yield
    finally:
        eval_all.make_eval_body = make_body
        os.chdir(cwd)


TRAIN_PHASES = {
    # phase: (extra train.main arguments, launches per step, kernel_bench path, what it runs)
    "train": ([], PER_STEP, "train", "fp32 static bands"),
    "train_fast": (["--fast"], PER_FAST_STEP, "fast", "fp32 --fast (w256 windows)"),
    "train_knn": (["kpconv_impl=banded_knn"], PER_KNN_STEP, "knn_train", "fp32 banded_knn (k = 128)"),
}


def train(device, seed, smi_line, phase="train"):
    """The trainer's main path through its CLI entry point, then a restore
    of its checkpoint and one eval_step on it; train_fast and train_knn
    then replay one B=1 step's window or tau layers (replay_step_layers)."""
    import shutil
    import tempfile

    import torch

    from cofii2p_tpu_torch import train as train_cli
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint
    from cofii2p_tpu_torch.utils.kernel_bench import train_config

    extra, per_step_want, bench_path, what = TRAIN_PHASES[phase]
    steps, frames_total = [], 40
    captured = {}

    root = tempfile.mkdtemp(prefix=f"{phase}_", dir=OUT_DIR)
    argv = ["kitti", f"root_path={root}", f"val_freq={TRAIN_STEPS}", "--synthetic", "--steps", str(TRAIN_STEPS),
            "--batch_size", str(BATCH), "--synthetic_frames", str(frames_total), *extra]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with recording_train_steps(steps, captured):
        save_dir = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # every step and the validation at the last one
    peak = torch.cuda.max_memory_allocated() / 2**30

    cfg = train_config(bench_path).replace(root_path=root, val_freq=TRAIN_STEPS)
    if captured["cfg"] != cfg:
        raise PhaseError(f"{phase}: train.main ran {captured['cfg']}, expected {cfg}")
    if len(steps) != TRAIN_STEPS:
        raise PhaseError(f"{phase}: {len(steps)} steps ran, expected {TRAIN_STEPS}")
    for i, (_, per_step, metrics, _) in enumerate(steps):
        for name, want in per_step_want.items():
            if per_step[name] != want:
                raise PhaseError(f"{phase}: step {i} launched {name} {per_step[name]} times, expected {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise PhaseError(f"{phase}: step {i} metrics not finite: {metrics}")
    model = captured["model"]
    moved = sum(int(not torch.equal(p.detach(), captured["before"][n])) for n, p in model.named_parameters())
    if moved == 0:
        raise PhaseError(f"{phase}: no parameter changed in 4 steps")
    path = latest_checkpoint(save_dir)
    if path is None:
        raise PhaseError(f"{phase}: no checkpoint under {save_dir}")
    restored = CoFiI2P(cfg).to(device)
    step_no = restore_checkpoint(path, restored)
    mismatched = [k for k, v in model.state_dict().items() if not torch.equal(v, restored.state_dict()[k])]
    if step_no != TRAIN_STEPS or mismatched:
        raise PhaseError(f"{phase}: checkpoint step {step_no}, {len(mismatched)} tensors differ after restore")
    hb = frames(cfg, BATCH, device, start=frames_total)
    recalls = train_lib.make_eval_step(cfg, restored)(
        hb, train_lib.make_train_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device))
    recalls = {k: float(v) for k, v in recalls.items()}
    if not all(math.isfinite(v) for v in recalls.values()):
        raise PhaseError(f"{phase}: eval_step on the restored checkpoint not finite: {recalls}")
    eval_line = fp32_eval_batches(cfg, restored, device, frames_total + BATCH) if phase == "train" else None
    shutil.rmtree(root, ignore_errors=True)
    del model, restored, captured
    torch.cuda.empty_cache()

    ms = [dt * 1e3 for dt, *_ in steps]
    steady = sum(ms[1:]) / max(len(ms) - 1, 1)
    say(phase, f"{TRAIN_STEPS} steps x {BATCH} frames ({cfg.img_H}x{cfg.img_W}, {cfg.num_pc} pts), {what}, "
        "through train.main "
        f"in {wall:.1f} s: losses " + " -> ".join(f"{m['loss']:.4f}" for _, _, m, _ in steps)
        + f", grad norm {steps[-1][2]['grad_norm']:.3f}; ms/step " + ", ".join(f"{x:.1f}" for x in ms)
        + f" (steady {steady:.1f} ms, {BATCH * 1e3 / steady:.2f} frames/s); peak {peak:.2f} GiB; "
        + "launches/step " + ", ".join(f"{k} {v}" for k, v in steps[-1][1].items() if v)
        + f"; {moved} parameter tensors moved; restored {os.path.basename(path)}, eval_step "
        + ", ".join(f"{k} {v:.3f}" for k, v in recalls.items()) + f"; card {smi_line}")
    if eval_line:
        say(phase, eval_line + f"; card {smi_line}")
    if phase != "train":
        try:
            say(phase, "B=1 step, " + replay_step_layers(cfg, device, seed, windows_only=phase == "train_fast"))
        except PhaseError as e:
            raise PhaseError(f"{phase}: {e}") from None
    return launches


def fp32_eval_batches(cfg, model, device, start):
    """The restored fp32 static model through evaluation/pipeline.py's
    make_eval_body, the body eval_all.main runs for a port checkpoint
    under `kitti`: EVAL_BATCHES batches of BATCH synthetic frames, launches
    per batch as PER_EVAL_FORWARD, finite poses wherever RANSAC succeeded;
    returns the line with the median ms and frames/s of the batches after
    the first."""
    import torch

    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body

    run = make_eval_body(cfg, model.eval())
    gen = torch.Generator(device).manual_seed(7)  # as eval_all.main seeds its draws
    times, succ, first = [], 0, None
    for i in range(EVAL_BATCHES):
        hb = frames(cfg, BATCH, device, start=start + i * BATCH)
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        out = run(hb, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per = {k: v - before[k] for k, v in read_launches().items()}
        first = first if i else per
        for name, want in body_launches(PER_EVAL_FORWARD, i == 0).items():
            if per[name] != want:
                raise PhaseError(f"fp32 static eval: batch {i} launched {name} {per[name]} times, expected {want}")
        finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
        if not finite[out.success].all():
            raise PhaseError(f"fp32 static eval: batch {i} has a non-finite pose where RANSAC succeeded")
        succ += int(out.success.sum())
    ms = sorted(t * 1e3 for t in times[1:])
    med = (ms[(len(ms) - 1) // 2] + ms[len(ms) // 2]) / 2
    return (f"fp32 static eval of the restored model (make_eval_body, {EVAL_BATCHES} batches x B={BATCH}): median "
            f"of batches 2-{EVAL_BATCHES} {med:.1f} ms ({BATCH * 1e3 / med:.2f} frames/s), batches "
            + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms; launches/batch "
            + ", ".join(f"{k} {first[k] // AT_CAPTURE}" for k in PER_EVAL_FORWARD if first[k])
            + f" (at the capture; graph replays after); RANSAC success {succ}/{EVAL_BATCHES * BATCH}, finite poses")


def check_pose(device, gen, tally):
    """EPnP-RANSAC at serving size (512 hypotheses, 1280 correspondences,
    B = 8 and 1) through the kernels (csrc/ransac_pnp.cu) and through the
    plain version on the same draws: scenes of known pose (0.5 px noise, 30%
    outlier pixels, half the rows masked), where B = 8 must recover the
    pose, and junk correspondences as seeded random weights give.  The same
    samples, hypothesis counts, inlier counts and success flags, the largest
    R and t gap, NaN where the plain version's is; each timed as serving
    replays it (one captured CUDA graph), beside its bound."""
    import math

    import torch

    from cofii2p_tpu_torch.pose import ransac
    from cofii2p_tpu_torch.utils.cuda_graphs import CudaGraphed
    from cofii2p_tpu_torch.utils.kernel_bench import bound_ms, time_ms

    hyp, n = 512, 1280
    K = torch.tensor([[362.0, 0, 128], [0, 362.0, 40], [0, 0, 1]])
    for b in (BATCH, 1):
        ang = (torch.rand(b, generator=gen) * 2 - 1) * math.pi
        c, s = torch.cos(ang), torch.sin(ang)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        R = torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1), torch.stack([-s, z, c], -1)], -2)
        t = (torch.rand(b, 3, generator=gen) * 20 - 10) * torch.tensor([1.0, 0.1, 1.0])
        u = torch.rand(b, n, 3, generator=gen)
        cam = torch.stack([u[..., 0] * 40 - 20, u[..., 1] * 4 - 2, u[..., 2] * 45 + 5], -1)
        world = (cam - t[:, None]) @ R  # cam = R world + t
        uv = cam @ K.T
        uv = uv[..., :2] / uv[..., 2:] + torch.randn(b, n, 2, generator=gen) * 0.5
        bad = torch.rand(b, n, generator=gen) < 0.3
        uv = torch.where(bad[..., None], torch.rand(b, n, 2, generator=gen) * torch.tensor([256.0, 80.0]), uv)
        mask = (torch.rand(b, n, generator=gen) > 0.5).float()
        junk = [torch.randn(b, n, 3, generator=gen) * 10 + torch.tensor([0.0, 0.0, 30.0]),
                torch.rand(b, n, 2, generator=gen) * torch.tensor([256.0, 80.0]), K.expand(b, 3, 3),
                (torch.rand(b, n, generator=gen) > 0.5).float()]
        lines = []
        for kind, data in (("scenes", [world, uv, K.expand(b, 3, 3), mask]), ("junk", junk)):
            args = [x.contiguous().to(device) for x in (ransac.gumbel_noise((b, hyp, n), gen, "cpu"), *data)]
            got, hk = ransac.ransac_pnp_kernel(*args, inlier_threshold=8.0)
            res = ransac.ransac_pnp(*args, inlier_threshold=8.0)
            want_h = ransac.ransac_hypotheses_plain(*args, inlier_threshold=8.0)
            want = ransac.ransac_pnp_plain(*args, inlier_threshold=8.0)
            torch.cuda.synchronize()
            share = (hk.counts.long() == want_h.counts).float().mean().item()
            nan_same = torch.equal(torch.isnan(got.R), torch.isnan(want.R)) and torch.equal(torch.isnan(got.t),
                                                                                             torch.isnan(want.t))
            fin_r = torch.isfinite(got.R) & torch.isfinite(want.R)
            fin_t = torch.isfinite(got.t) & torch.isfinite(want.t)
            r_gap = (got.R - want.R)[fin_r].abs().max().item() if fin_r.any() else 0.0
            t_gap = (got.t - want.t)[fin_t].abs().max().item() if fin_t.any() else 0.0
            if not (torch.equal(hk.samples.long(), want_h.samples) and share >= 0.999 and nan_same
                    and torch.equal(got.num_inliers, want.num_inliers) and torch.equal(got.success, want.success)
                    and torch.equal(res.R, got.R) and r_gap <= 1e-4 and t_gap <= 1e-4):
                raise PhaseError(f"pose: {kind} B={b}: samples equal {torch.equal(hk.samples.long(), want_h.samples)}, "
                                 f"counts equal on {share:.5f}, inliers {got.num_inliers.tolist()} vs "
                                 f"{want.num_inliers.tolist()}, NaN alike {nan_same}, |dR| {r_gap:.2e}, |dt| {t_gap:.2e}")
            if kind == "scenes" and b == BATCH:
                r_err = (got.R.cpu() - R).abs().max().item()
                t_err = (got.t.cpu() - t).norm(dim=-1).max().item()
                if not (got.success.all() and r_err <= 1e-2 and t_err <= 0.1):
                    raise PhaseError(f"pose: success {got.success.tolist()}, max |R - R_gt| {r_err:.2e}, "
                                     f"|t - t_gt| {t_err:.3f} m")
            # as serving runs it: one captured graph, replayed
            times = {}
            for name, fn in (("kernel", ransac.ransac_pnp), ("plain", ransac.ransac_pnp_plain)):
                graphed = CudaGraphed(fn, "cofii2p.ransac")
                graphed(*args)
                times[name] = time_ms(lambda: graphed(*args), reps=20 if name == "kernel" else 5)
            # the least time: the Gumbel noise and the correspondences read once, or scoring's
            # b * hyp * n reprojections at 42 FLOP each (R p + t 18, K cam 15, divide, residual,
            # norm and compare 9) on the CUDA cores
            bound, by = bound_ms((b * hyp * n + b * n * 6) * 4, ops32=b * hyp * n * 42)
            tally.add("ransac_pnp", max(r_gap, t_gap), times["kernel"], times["plain"], (bound, by))
            lines.append(f"{kind}: samples bit-equal, hypothesis counts equal on {share:.5f}, inliers equal "
                         f"{got.num_inliers.tolist()}, NaN alike, max |dR| {r_gap:.1e}, |dt| {t_gap:.1e}; kernel "
                         f"{times['kernel']:.3f} ms, plain {times['plain']:.3f} ms (graph replays), bound {bound:.4f} ms")
        say("pose", f"B={b} x {n} correspondences, {hyp} hypotheses: " + "; ".join(lines))


def serve(device, seed, smi_line, profile=False, residual_fused=False, n_requests=REQUESTS):
    import torch

    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize
    from cofii2p_tpu_torch.utils.kernel_bench import serve_config
    from cofii2p_tpu_torch.utils.profiling import counter

    phase = "serve_resfuse" if residual_fused else "serve"
    per_forward = PER_RESFUSE_FORWARD if residual_fused else PER_FORWARD
    cfg = serve_config(residual_fused)
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(device).eval()
    run = make_eval_body(cfg, model)
    requests = [frames(cfg, BATCH, device, start=i * BATCH) for i in range(n_requests + 1)]
    gen = torch.Generator(device).manual_seed(seed)
    reset_launches()
    nodes, captures = (counter(f"cofii2p.ransac.{c}").value for c in ("graph_nodes", "captures"))
    windows = {k: counter(f"cofii2p.windows.{k}").value for k in ("kernel", "plain")}
    run(requests[0], gen)  # warm-up: every stage's graph capture
    torch.cuda.synchronize()
    captured = read_launches()
    windows = {k: counter(f"cofii2p.windows.{k}").value - v for k, v in windows.items()}
    graph_nodes = (counter("cofii2p.ransac.graph_nodes").value - nodes) // max(
        1, counter("cofii2p.ransac.captures").value - captures)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [run(hb, gen) for hb in requests[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    if captured["ransac_pnp"] != RANSAC_AT_CAPTURE or launches["ransac_pnp"]:
        raise PhaseError(f"{phase}: the RANSAC kernels launched {captured['ransac_pnp']} times at the warm-up's "
                         f"capture (expected {RANSAC_AT_CAPTURE}) and {launches['ransac_pnp']} times in the timed "
                         "requests (expected 0: graph replays)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        from cofii2p_tpu_torch.utils.profiling import trace

        with trace(os.path.join(OUT_DIR, phase)) as prof:
            run(requests[1], gen)
        with open(os.path.join(OUT_DIR, phase, "profile.txt"), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
        say(phase, f"profile of one request written to chiprun_out/{phase}/ (profile.txt, trace.json, spans.json)")
    for name, want in per_forward.items():
        if want and captured[name] == 0:
            raise PhaseError(f"{phase}: kernel {name} was never launched on the main path")
        if captured[name] != AT_CAPTURE * want or launches[name]:
            raise PhaseError(
                f"{phase}: {name} launched {captured[name]} times at the capture and {launches[name]} in "
                f"{n_requests} replayed requests, expected {want} a forward twice, then none "
                + ("(10 KPConvs, 4 strided blocks' conv and shortcut in one pass, 8 layers x 2 attention calls, "
                   "47 group norms, 5 window placements)" if residual_fused else
                   "(14 KPConvs, 4 strided shortcuts, 8 layers x 2 attention calls, 47 group norms, 5 window "
                   "placements)")
            )
    if windows != {"kernel": AT_CAPTURE * WINDOW_PAIRS, "plain": 0}:
        raise PhaseError(f"{phase}: window placements counted {windows} at the capture, expected kernel "
                         f"{AT_CAPTURE * WINDOW_PAIRS}, plain 0")
    nonfinite_pose = check_pose_outputs(phase, outs, cfg, device)
    fps = n_requests * BATCH / dt
    succ = sum(int(o.success.sum()) for o in outs)
    say(phase, f"{n_requests} requests x {BATCH} frames (160x512, 20480 pts), bf16 w192"
        + (", kpconv_residual_fused" if residual_fused else "") + f": {fps:.2f} frames/s, "
        f"{dt / n_requests * 1e3:.1f} ms/request, peak {peak:.2f} GiB, launches/forward at the capture "
        + ", ".join(f"{k} {captured[k] // AT_CAPTURE}" for k in per_forward)
        + ", none in the replayed requests; graph nodes "
        + ", ".join(f"{k} {v}" for k, v in stage_nodes().items())
        + f"; RANSAC: {RANSAC_AT_CAPTURE} kernel calls at the capture, 0 in the requests, a graph of {graph_nodes} "
        f"nodes, success {succ}/{n_requests * BATCH}, non-finite poses {nonfinite_pose} (all without success); "
        f"card {smi_line}")
    try:
        if residual_fused:
            say(phase, check_resfuse_against_pair(cfg, model, requests[1], device, seed))
            say(phase, check_resfuse_fp32(device, seed))
        else:
            say(phase, check_serve_drift(cfg, model, requests[1], device, seed))
    except PhaseError as e:
        raise PhaseError(f"{phase}: {e}") from None
    del model, run, requests, outs
    torch.cuda.empty_cache()
    # the kernels run at the capture alone: report those calls
    return captured, fps, peak


def graphs(device, seed, smi_line, n_requests=REQUESTS):
    """The graphed serving body against the eager one (the phase list's
    `graphs`): per case, the eager body's requests and timing, then the
    graphed body's, each body alone on the card for its peak."""
    import gc

    import torch

    from cofii2p_tpu_torch.config import KITTIConfig, apply_overrides
    from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws, make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils import profiling
    from cofii2p_tpu_torch.utils.convert import randomize
    from cofii2p_tpu_torch.utils.cuda_graphs import serving_stages
    from cofii2p_tpu_torch.utils.kernel_bench import serve_config, t7_model

    def bits(x):
        return x.view(torch.int32 if x.element_size() == 4 else torch.int16) if x.is_floating_point() else x

    cases = [("serve", BATCH, {}), ("serve", 1, {}), ("t7", BATCH, []), ("t7", BATCH, ["kpconv_impl=gather"])]
    cases += [(what, BATCH, over) for what, over in VARIANTS]
    for name, b, over in cases:
        if name == "t7":
            cfg = reference_ckpt_config(apply_overrides(KITTIConfig(), over), over, device)
            model = t7_model(cfg, seed, device)
            name = " ".join(["t7", *over])
        else:
            cfg = serve_config().replace(**over)
            model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(device).eval()
        stages = serving_stages(cfg)
        requests = [(frames(cfg, b, device, start=(i % 4) * b),
                     make_draws(cfg, b, torch.Generator(device).manual_seed(seed + i), device))
                    for i in range(n_requests + 2)]
        readings = {}
        profiling.reset()  # the counters: this case's captures alone
        for kind in ("eager", "graphed"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = make_eval_body(cfg, model, stages=() if kind == "eager" else None)
            outs = [run(hb, draws=d) for hb, d in requests[:2]]  # the graphed body captures, then replays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for hb, d in requests[2:]:
                run(hb, draws=d).R.cpu()
            ms = (time.perf_counter() - t0) / n_requests * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            waits, kpconv_ms = profiled_requests(run, model, requests[2:5])
            readings[kind] = (outs, ms, peak, kpconv_ms)
            if kind == "graphed" and "prep" in stages:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                hb, d = requests[2]
                try:
                    run(hb, draws=d)
                except RuntimeError as e:
                    raise PhaseError(f"graphs: {name} B={b}: a replayed request synchronised: {e}") from None
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if waits:
                    raise PhaseError(f"graphs: {name} B={b}: replayed requests' traces hold {waits}")
            del run, outs
        for i in range(2):
            for field in readings["eager"][0][i]._fields:
                a, g = (getattr(readings[k][0][i], field) for k in ("eager", "graphed"))
                if not torch.equal(bits(a), bits(g)):
                    raise PhaseError(f"graphs: {name} B={b}: request {i} field {field} differs from the eager body's")
        (_, e_ms, e_peak, e_kp), (_, g_ms, g_peak, g_kp) = readings["eager"], readings["graphed"]
        if not 0.5 * e_kp <= g_kp <= 2.0 * e_kp:
            raise PhaseError(f"graphs: {name} B={b}: KPConv ranges hold {g_kp:.3f} device ms a replayed request, "
                             f"{e_kp:.3f} eagerly: the KPConv parts do not replay inside their modules' calls")
        nodes = stage_nodes()
        if any(nodes[st] == 0 for st in stages) or any(nodes[st] for st in nodes if st not in stages):
            raise PhaseError(f"graphs: {name} B={b}: graph nodes {nodes}, captured stages {stages}")
        synced = ("a replayed request synchronises nowhere (sync debug mode; no wait and no pageable copy in three "
                  "profiled requests' cofii2p.eval)" if "prep" in stages else
                  "prep eager (its k-NN maps wait for the card), every other stage replayed")
        say("graphs", f"{name} B={b}: outputs bit-equal to the eager body's (capture and replay), {synced}; graph "
            f"nodes " + ", ".join(f"{k} {v}" for k, v in nodes.items())
            + f"; KPConv ranges' device ms a request eager {e_kp:.3f}, graphed {g_kp:.3f}; {n_requests} closed-loop "
            f"requests: eager {e_ms:.2f} ms, graphed {g_ms:.2f} ms a request ({b * 1e3 / e_ms:.2f} -> "
            f"{b * 1e3 / g_ms:.2f} frames/s); peak {e_peak:.4f} -> {g_peak:.4f} GiB; card {smi_line}")
        del model, requests, readings
        gc.collect()
        torch.cuda.empty_cache()


def profiled_requests(run, model, requests):
    """Profiles ``run`` on each request, with a range around every KPConv
    forward as the benchmark's traced runs set (benchmark/harness/
    tracing.py::scopes).  Returns, by name, the calls that make the host
    wait for the card (stream, device or event synchronise, a synchronous
    copy) and the copies from pageable host memory that fall inside a
    ``cofii2p.eval`` span of the chrome trace; and the device ms a request
    of the kernels launched inside KPConv ranges."""
    import json
    import tempfile

    import torch

    from benchmark.harness import tracing

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, tracing.scopes(model, "KPConv", "smoke.kpconv"):
        with torch.autograd.profiler.record_function("smoke.window"):
            for hb, d in requests:
                run(hb, draws=d)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            xs = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
        kpconv_ms = tracing.read_trace(path, "smoke.window", ["smoke.kpconv"])["scoped_ms"]["smoke.kpconv"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in xs
             if e["name"] == "cofii2p.eval" and e.get("cat") == "user_annotation"]
    if len(spans) != len(requests):
        raise PhaseError(f"graphs: {len(spans)} cofii2p.eval spans in the trace of {len(requests)} requests")
    waits = {}
    for e in xs:
        name = e["name"]
        wait = (e.get("cat") == "cuda_runtime" and name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                                              "cudaEventSynchronize", "cudaMemcpy")
                or e.get("cat") == "gpu_memcpy" and "Pageable" in name)
        if wait and any(s <= e["ts"] <= t for s, t in spans):
            waits[name] = waits.get(name, 0) + 1
    return waits, kpconv_ms / len(requests)


def check_serve_drift(cfg, model, hb, device, seed, per_forward=PER_FORWARD):
    """The drift tool's four readings (cofii2p_tpu_torch/tools/
    window_drift.py::drift) between one bf16 B=8 serving forward through the kernels and the same weights, frames and draws
    through the plain versions on the card (kpconv_kernel='xla' and the
    attention wrapper's plain version, which keeps the kernel's bf16
    output; 'full' would return fp32): coarse-argmax drift, selection
    drift, fine-cell drift among the selected superpoints and max score
    drift.  Each must stay within twice the parent kernels' reading plus
    one point (SERVE_DRIFT_LIMITS).  Both forwards place their windows by
    #19, which gives the plain version's starts."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models import transformer as tf
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.ops.attention_kernel import fused_attention_plain
    from cofii2p_tpu_torch.tools.window_drift import drift, outputs, selected

    draws = make_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    plain = CoFiI2P(cfg.replace(kpconv_kernel="xla")).to(device).eval()
    plain.load_state_dict(model.state_dict())
    kernel_attention = tf.fused_attention
    with torch.no_grad():
        reset_launches()
        got = outputs(model, batch, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        tf.fused_attention = fused_attention_plain
        try:
            ref = outputs(plain, batch, cfg)
            torch.cuda.synchronize()
        finally:
            tf.fused_attention = kernel_attention
        plain_launches = read_launches()
    del plain
    # the plain forward launches nothing but its window placements: #19 takes
    # every placement off the CPU, whatever the setting (the plain version's
    # starts, bit for bit)
    if (plain_launches != dict(launches, window_starts=2 * launches["window_starts"])
            or launches["kpconv_fused"] != per_forward["kpconv_fused"]
            or launches["window_starts"] != per_forward["window_starts"]):
        raise PhaseError(f"drift: launches {launches} through the kernels, {plain_launches} after the plain forward")
    d, n_sel = drift(ref, got), selected(ref, got)
    over = {k: v for k, v in d.items() if v > SERVE_DRIFT_LIMITS[k]}
    line = (f"drift of a B={BATCH} forward, kernels vs plain versions (same weights, frames, draws; {n_sel} "
            f"superpoints selected by either): coarse-argmax {d['argmax']:.4f}, selection "
            f"{d['selection']:.4f}, fine-cell (selected) {d['fine_cell']:.4f}, max score {d['score']:.5f}; "
            "limits " + ", ".join(f"{k} {v:.4f}" for k, v in SERVE_DRIFT_LIMITS.items()))
    if over:
        raise PhaseError(f"{line}: over the limit in {sorted(over)}")
    return line


class captured_outputs:
    """Within the context, ``outs[name]`` lists what each named kernel
    wrapper (kernel_bench.kernel_wrappers) returned, in call order."""

    def __init__(self, *names):
        self.names, self.outs = names, {n: [] for n in names}

    def __enter__(self):
        from cofii2p_tpu_torch.utils.kernel_bench import kernel_wrappers

        self.patched = []
        for name in self.names:
            mod, fn, _ = kernel_wrappers()[name]

            def rec(*a, _fn=fn, _name=name, **kw):
                res = _fn(*a, **kw)
                self.outs[_name].append(res)
                return res

            rec.launches = 0  # the wrapper counts on the attribute it is found by
            self.patched.append((mod, name, fn))
            setattr(mod, name, rec)
        return self.outs

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)


def check_resfuse_against_pair(cfg, model, hb, device, seed):
    """One bf16 B=8 forward of the serving model with the flag and of the
    same weights without it, on the same frames and draws: FPN outputs
    within 1e-3 (the fp32 phase's tolerance) and every strided block's
    shortcut bit-equal (#16's against #3's)."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P

    draws = make_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    pair = CoFiI2P(cfg.replace(kpconv_residual_fused=False)).to(device).eval()
    pair.load_state_dict(model.state_dict())
    with torch.no_grad():
        with captured_outputs("banded_residual_fused") as fused:
            got = model(batch)["pc_features"]
        with captured_outputs("banded_maxpool_fused") as unfused:
            ref = pair(batch)["pc_features"]
    torch.cuda.synchronize()
    shortcuts = [r[2] for r in fused["banded_residual_fused"]]
    pooled = unfused["banded_maxpool_fused"]
    if len(shortcuts) != 4 or len(pooled) != 4:
        raise PhaseError(f"{len(shortcuts)} fused and {len(pooled)} separate shortcuts per forward, expected 4 each")
    bad = [i for i, (a, b) in enumerate(zip(shortcuts, pooled)) if not torch.equal(a, b)]
    if bad:
        raise PhaseError(f"the shortcuts of strided blocks {[f'encoder{i + 2}_1' for i in bad]} differ from #3's")
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    same = all(torch.equal(g, r) for g, r in zip(got, ref))
    if max(errs) > 1e-3:
        raise PhaseError(f"FPN outputs with and without the flag differ: rel {errs} (<= 1e-3)")
    del pair
    return (f"B={BATCH} forward with the flag vs without, same weights, frames and draws: 4 strided shortcuts "
            f"bit-equal to #3's; FPN outputs rel " + ", ".join(f"{e:.2e}" for e in errs)
            + (" (bit-equal)" if same else ""))


def check_resfuse_fp32(device, seed):
    """A B=1 fp32 forward of KITTIConfig (static bands) with the flag,
    through the kernels and through kpconv_kernel='xla': encoder2_1-4_1
    take #16 (encoder5_1's shapes exceed residual_fused_fits, so it runs
    #1 and #3); FPN and transformer outputs within 1e-3."""
    from cofii2p_tpu_torch.config import KITTIConfig

    launches, errs = fp32_forward(KITTIConfig(kpconv_residual_fused=True, attention="pallas"), device, seed)
    if launches["residual_fused"] != 3 or launches["maxpool"] != 1:
        raise PhaseError(f"fp32 static forward launched residual_fused {launches['residual_fused']} and maxpool "
                         f"{launches['maxpool']} times, expected 3 and 1")
    return ("B=1 fp32 static-band forward with the flag, kernels vs kpconv_kernel='xla': residual_fused 3, "
            f"maxpool 1 launches (encoder5_1 unfused); " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def t7(device, seed, smi_line):
    """The `.t7` eval path through its CLI entry point, then one B=1 forward
    of the same model through the kernels and through the plain versions."""
    import shutil
    import tempfile

    import torch

    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.evaluation import eval_all
    from cofii2p_tpu_torch.utils.checkpoint import export_t7
    from cofii2p_tpu_torch.utils.kernel_bench import t7_model

    frames_total = 16
    root = tempfile.mkdtemp(prefix="t7_", dir=OUT_DIR)
    try:
        cfg = eval_all.reference_ckpt_config(KITTIConfig(), [], device)
        ckpt = os.path.join(root, "ref.t7")
        export_t7(t7_model(cfg, seed, "cpu"), ckpt)

        batches = []
        argv = [ckpt, "kitti", "--synthetic", "--synthetic_frames", str(frames_total), "--batch_size", str(BATCH),
                "--eval_path", root]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with recording_eval_batches(batches, root):
            r_errs, _ = eval_all.main(argv)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30

        dumps = check_eval_all_run("t7", batches, PER_T7_FORWARD, frames_total, root, "kitti")
        fps = batches[1][3] / batches[1][0]
        succ = sum(int(o.success.sum()) for _, _, o, *_ in batches)
        say("t7", "eval_all.main on ref.t7 (seeded weights, per-layer kernel points), "
            f"{frames_total} frames x B={BATCH}, fp32 {cfg.kpconv_impl}, attention {cfg.attention}: {dumps} "
            "dumps with the reference's keys and both error arrays; second batch "
            f"{batches[1][0] * 1e3:.1f} ms ({fps:.2f} frames/s), first {batches[0][0] * 1e3:.1f} ms; "
            f"peak {peak:.2f} GiB; launches/forward at the capture "
            + ", ".join(f"{k} {batches[0][1][k] // AT_CAPTURE}" for k in PER_T7_FORWARD)
            + ", none in the replayed batches"
            + f"; RANSAC success {succ}/{frames_total} ({len(r_errs)} errors written); card {smi_line}")
    finally:
        shutil.rmtree(root, ignore_errors=True)  # ref.t7 is ~200 MB
    say("t7", check_t7_forward(cfg, device, seed))
    return launches, fps, peak


def check_t7_forward(cfg, device, seed):
    """One B=1 fp32 forward of the `.t7` model through the kernels and
    through kpconv_kernel='xla': the 9 pairs' tau bit-equal, each tau
    KPConv call's active-row count equal to its plain version's on the same
    inputs, FPN outputs within 1e-4."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models import kpconv as kpc
    from cofii2p_tpu_torch.utils.kernel_bench import kernel_wrappers, recording, t7_model

    hb = frames(cfg, 1, device)
    draws = make_draws(cfg, 1, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    knn_tau = kpc.knn_tau
    taus, feats, calls = {}, {}, []
    for name, c in (("kernels", cfg), ("plain", cfg.replace(kpconv_kernel="xla"))):
        model = t7_model(c, seed, device)
        got = taus[name] = []

        def rec(*a, _got=got, **kw):
            _got.append(knn_tau(*a, **kw))
            return _got[-1]

        kpc.knn_tau = rec
        try:
            with torch.no_grad(), recording(calls if name == "kernels" else []):
                feats[name] = model(batch)["pc_features"]
        finally:
            kpc.knn_tau = knn_tau
        del model
    torch.cuda.synchronize()
    if len(taus["kernels"]) != 9 or len(taus["plain"]) != 9:
        raise PhaseError(f"t7: {len(taus['kernels'])} and {len(taus['plain'])} taus per forward, expected 9")
    bad = [i for i, (a, b) in enumerate(zip(taus["kernels"], taus["plain"])) if not torch.equal(a.view(torch.int32),
                                                                                              b.view(torch.int32))]
    if bad:
        raise PhaseError(f"t7: tau of pairs {bad} differs between the kernels and the plain versions")
    wrappers = kernel_wrappers()
    worst, n_conv = 0.0, 0
    with torch.no_grad():
        for name, a, kw in calls:
            if name not in ("banded_kpconv_fused_tau", "banded_kpconv_aggregate_tau"):
                continue
            _, kern, plain = wrappers[name]
            (out, cnt), (ref, ref_cnt) = kern(*a, **kw), plain(*a, **kw)
            if not torch.equal(cnt, ref_cnt):
                raise PhaseError(f"t7: {name} M={a[1].shape[1]}: counts differ at {(cnt != ref_cnt).sum().item()}")
            worst, n_conv = max(worst, rel_err(out, ref)), n_conv + 1
    errs = [rel_err(g, r) for g, r in zip(feats["kernels"], feats["plain"])]
    if n_conv != 14 or max(errs) > 1e-4 or worst > 1e-4:
        raise PhaseError(f"t7: {n_conv} tau KPConvs (14 expected), worst rel {worst:.2e}; FPN rel errors {errs} "
                         "(<= 1e-4)")
    return (f"B=1 fp32 forward, kernels vs kpconv_kernel='xla': 9 pair taus bit-equal; 14 tau KPConvs on their own "
            f"inputs, counts equal, worst rel {worst:.2e}; FPN outputs rel "
            + ", ".join(f"{e:.2e}" for e in errs))


KNN_PARTS = ("sq_dist_fma", "_kth_value", "_take_lowest")  # ops/knn.py: d2 chain, torch.topk, tie pass


@contextlib.contextmanager
def timed_knn(events, parts):
    """The pyramid's k-NN searches (ops/pyramid.py's knn and
    knn_index_order) timed by CUDA events: each call appends its (start,
    end) events to ``events``, and within it each call of a KNN_PARTS
    function of ops/knn.py appends its own to ``parts[name]``."""
    import importlib

    import torch

    from cofii2p_tpu_torch.ops import pyramid

    knn_mod = importlib.import_module("cofii2p_tpu_torch.ops.knn")  # the package exports knn, the function

    originals = [(pyramid, name, getattr(pyramid, name)) for name in ("knn", "knn_index_order")]
    originals += [(knn_mod, name, getattr(knn_mod, name)) for name in KNN_PARTS]
    inside = [False]

    def timed(fn, sink, search):
        def call(*a, **kw):
            if not search and not inside[0]:
                return fn(*a, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            inside[0] = inside[0] or search
            try:
                out = fn(*a, **kw)
            finally:
                inside[0] = inside[0] and not search
            end.record()
            sink.append((start, end))
            return out

        return call

    for mod, name, fn in originals:
        search = mod is pyramid
        setattr(mod, name, timed(fn, events if search else parts.setdefault(name, []), search))
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def t7_gather(device, seed, smi_line):
    """`eval_all <ref.t7> kitti ... kpconv_impl=gather` through its CLI entry
    point on the t7 phase's seeded checkpoint, then the drift between one
    B = 8 forward under gather and one under banded_knn."""
    import shutil
    import tempfile

    import torch

    from cofii2p_tpu_torch.config import KITTIConfig, apply_overrides
    from cofii2p_tpu_torch.evaluation import eval_all
    from cofii2p_tpu_torch.utils import profiling
    from cofii2p_tpu_torch.utils.checkpoint import export_t7
    from cofii2p_tpu_torch.utils.kernel_bench import t7_model

    frames_total, overrides = 16, ["kpconv_impl=gather"]
    knn_cfg = eval_all.reference_ckpt_config(KITTIConfig(), [], device)
    cfg = eval_all.reference_ckpt_config(apply_overrides(KITTIConfig(), overrides), overrides, device)
    root = tempfile.mkdtemp(prefix="t7_gather_", dir=OUT_DIR)
    try:
        ckpt = os.path.join(root, "ref.t7")
        export_t7(t7_model(knn_cfg, seed, "cpu"), ckpt)  # the t7 phase's checkpoint, byte for byte
        batches, events, parts = [], [], {}
        argv = [ckpt, "kitti", "--synthetic", "--synthetic_frames", str(frames_total), "--batch_size", str(BATCH),
                "--eval_path", root, *overrides]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        profiling.reset()  # the counters: this run's captures alone
        with recording_eval_batches(batches, root), timed_knn(events, parts):
            r_errs, _ = eval_all.main(argv)
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.synchronize()
        dumps = check_eval_all_run("t7_gather", batches, PER_T7_GATHER_FORWARD, frames_total, root, "kitti")
        # the stage list leaves prep eager under gather (its k-NN maps wait
        # for the card), so the searches above ran in every batch as users
        # run them; every other stage was captured once
        nodes = stage_nodes()
        if nodes["prep"] or not all(v for k, v in nodes.items() if k != "prep"):
            raise PhaseError(f"t7_gather: graph nodes {nodes}: expected prep eager and every other stage captured")
        if len(events) != MAP_SEARCHES * len(batches):
            raise PhaseError(f"t7_gather: {len(events)} k-NN map searches in {len(batches)} batches, expected "
                             f"{MAP_SEARCHES} a batch")
        knn_ms = [sum(a.elapsed_time(b) for a, b in events[i * MAP_SEARCHES:(i + 1) * MAP_SEARCHES])
                  for i in range(len(batches))]
        split = {}  # the second batch's share of each part (every batch makes the same calls)
        for name in KNN_PARTS:
            per = len(parts.get(name, [])) // len(batches)
            if per == 0 or per * len(batches) != len(parts[name]):
                raise PhaseError(f"t7_gather: {len(parts.get(name, []))} calls of ops/knn.py's {name} in "
                                 f"{len(batches)} batches")
            split[name] = sum(a.elapsed_time(b) for a, b in parts[name][per:2 * per])
        ms = batches[1][0] * 1e3
        succ = sum(int(o.success.sum()) for _, _, o, *_ in batches)
        say("t7_gather", f"eval_all.main on ref.t7 with kpconv_impl=gather (seeded weights, per-layer kernel points), "
            f"{frames_total} frames x B={BATCH}, fp32, attention {cfg.attention}: {dumps} dumps with the reference's "
            f"keys and both error arrays; second batch {ms:.1f} ms ({BATCH * 1e3 / ms:.2f} frames/s), first "
            f"{batches[0][0] * 1e3:.1f} ms; the {MAP_SEARCHES} k-NN map searches (CUDA events) "
            + ", ".join(f"{x:.1f}" for x in knn_ms) + f" ms a batch ({knn_ms[1] / ms:.1%} of the second; of its "
            f"{knn_ms[1]:.1f} ms the d2 chain {split['sq_dist_fma']:.1f}, torch.topk's k-th value "
            f"{split['_kth_value']:.1f}, the tie pass {split['_take_lowest']:.1f}, the rest "
            f"{knn_ms[1] - sum(split.values()):.1f}); peak "
            f"{peak:.2f} GiB; graphed body (prep eager): attention launched {batches[0][1]['attention']} times at the "
            f"capture, {batches[1][1]['attention']} in the second batch, every other kernel 0; graph nodes "
            + ", ".join(f"{k} {v}" for k, v in nodes.items()) + f"; RANSAC "
            f"success {succ}/{frames_total} ({len(r_errs)} errors written); card {smi_line}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("t7_gather", gather_drift(cfg, knn_cfg, device, seed))


def gather_drift(cfg, knn_cfg, device, seed):
    """The drift tool's four readings between one B = 8 fp32 forward
    of the `.t7` model under gather and one under banded_knn (kernels #5-#8
    and #4), on the same weights, frames and draws: what the banded k-NN
    plan costs at KITTI scale.  Printed, with no limit."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.tools.window_drift import drift, outputs, selected
    from cofii2p_tpu_torch.utils.kernel_bench import t7_model

    hb = frames(cfg, BATCH, device)
    draws = make_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device)
    outs, launches, states = {}, {}, {}
    for name, c in (("gather", cfg), ("banded_knn", knn_cfg)):
        model = t7_model(c, seed, device)
        states[name] = {k: v.sum().item() for k, v in model.state_dict().items()}
        batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], c, draws["perms"])
        with torch.no_grad():
            reset_launches()
            outs[name] = outputs(model, batch, c)
            torch.cuda.synchronize()
            launches[name] = read_launches()
        del model, batch
    if states["gather"] != states["banded_knn"]:
        raise PhaseError("t7_gather drift: the two models' weights differ")
    for name, want in (("gather", PER_T7_GATHER_FORWARD), ("banded_knn", PER_T7_FORWARD)):
        bad = {k: launches[name][k] for k, v in want.items() if launches[name][k] != v}
        if bad:
            raise PhaseError(f"t7_gather drift: the {name} forward launched {bad}, expected {want}")
    d, n_sel = drift(outs["gather"], outs["banded_knn"]), selected(outs["gather"], outs["banded_knn"])
    return (f"drift of a B={BATCH} fp32 forward, gather vs banded_knn (kernels #5-#8; same weights, frames, draws; "
            f"{n_sel} superpoints selected by either): coarse-argmax {d['argmax']:.4f}, selection "
            f"{d['selection']:.4f}, fine-cell (selected) {d['fine_cell']:.4f}, max score {d['score']:.5f}")


def train_gather(device, seed, smi_line):
    """`train kitti --synthetic kpconv_impl=gather` for 2 steps through
    train.main at B = 8, or at the largest of 4, 2, 1 that fits when B = 8
    runs out of memory: no kernel launched, finite losses, parameters
    moved, a checkpoint written; ms a step, frames/s and peak memory."""
    import gc
    import shutil
    import tempfile

    import torch

    from cofii2p_tpu_torch import train as train_cli
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint

    steps_n, refused = 2, []
    for bs in (BATCH, 4, 2, 1):
        steps, captured = [], {}
        root = tempfile.mkdtemp(prefix="train_gather_", dir=OUT_DIR)
        argv = ["kitti", f"root_path={root}", "val_freq=1000", "--synthetic", "--steps", str(steps_n),
                "--batch_size", str(bs), "--synthetic_frames", str(steps_n * bs), "kpconv_impl=gather"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            with recording_train_steps(steps, captured):
                save_dir = train_cli.main(argv)
        except torch.cuda.OutOfMemoryError:
            refused.append((bs, torch.cuda.max_memory_allocated() / 2**30))
            shutil.rmtree(root, ignore_errors=True)
            continue
        break
    else:
        raise PhaseError(f"train_gather: out of memory at every batch size: {refused}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    if len(steps) != steps_n or captured["cfg"].kpconv_impl != "gather":
        raise PhaseError(f"train_gather: {len(steps)} steps of {captured['cfg'].kpconv_impl}, expected {steps_n} of "
                         "gather")
    for i, (_, per_step, metrics, _) in enumerate(steps):
        launched = {k: v for k, v in per_step.items() if v}
        if launched:
            raise PhaseError(f"train_gather: step {i} launched {launched}; the gather path runs no kernel")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise PhaseError(f"train_gather: step {i} metrics not finite: {metrics}")
    model = captured["model"]
    moved = sum(int(not torch.equal(p.detach(), captured["before"][n])) for n, p in model.named_parameters())
    path = latest_checkpoint(save_dir)
    shutil.rmtree(root, ignore_errors=True)
    del model, captured
    torch.cuda.empty_cache()
    if moved == 0 or path is None:
        raise PhaseError(f"train_gather: {moved} parameter tensors moved, checkpoint {path}")
    ms = [dt * 1e3 for dt, *_ in steps]
    cut = (f"; B = {BATCH} ran out of memory (peak at the failure " + ", ".join(f"B={b}: {p:.2f} GiB" for b, p in refused)
           + f"), cut to B = {bs}") if refused else ""
    say("train_gather", f"{steps_n} steps x {bs} frames, fp32 gather (k = 128 maps, kernel points shared per level), "
        f"through train.main: losses " + " -> ".join(f"{m['loss']:.4f}" for _, _, m, _ in steps)
        + "; ms/step " + ", ".join(f"{x:.1f}" for x in ms) + f" ({bs * 1e3 / ms[-1]:.2f} frames/s at the second); "
        f"peak {peak:.2f} GiB; no kernel launched; {moved} parameter tensors moved, checkpoint "
        f"{os.path.basename(path)}{cut}; card {smi_line}")


def check_recorded_calls(calls):
    """Each kernel call a bf16 serving forward made, replayed on its own
    inputs through the kernel and its plain version, at the kernels phase's
    bf16 gates: #1 and #2 counts equal to and rel <= 5e-2 against the bf16
    plain version, which rounds as the kernel does (#16's gate there; both
    distances from the fp32 plain version are printed, not gated: on these
    activations bf16's own rounding exceeds the 5e-2 that the phase's
    synthetic features meet); #3 bit-equal; #4 within bf16's rounding of
    the fp32 plain version plus ATTN_BF16_EXCESS (the phase's abs <= 2e-2
    is for its synthetic inputs' magnitudes, so it is printed, not gated);
    #18's statistics within 1e-5 and the same bits on two launches, its
    apply bit-equal on the plain statistics (point_norm_gaps).
    Returns a line; fails on the first call over a gate."""
    import inspect

    import torch

    from cofii2p_tpu_torch.ops.attention_kernel import full_attention
    from cofii2p_tpu_torch.utils.kernel_bench import kernel_wrappers

    wrappers = kernel_wrappers()
    seen = {}  # name -> (calls, worst reading, widest C)
    far = {}  # #1 and #2: the worst distances of the kernel and of the bf16 plain version from the fp32 plain
    with torch.no_grad():
        for name, a, kw in calls:
            _, kern, plain = wrappers[name]
            arg = inspect.signature(kern).bind(*a, **kw)
            arg.apply_defaults()
            arg = dict(arg.arguments)
            if name in ("banded_kpconv_fused", "banded_kpconv_aggregate_fused"):
                cin = arg["s_feats"].shape[-1]
                where = f"{name} Cin {cin} M {arg['q_points'].shape[1]} N {arg['s_points'].shape[1]} " \
                        f"K {arg['kernel_size']}"
                out, cnt = kern(**arg)
                ref, cnt_ref = plain(**arg)
                ref32 = plain(**{**arg, "s_feats": arg["s_feats"].float(), "dtype": torch.float32})[0]
                torch.cuda.synchronize()
                err, e32, p32 = rel_err(out, ref), rel_err(out, ref32), rel_err(ref, ref32)
                if not torch.equal(cnt, cnt_ref) or err > 5e-2:
                    raise PhaseError(f"{where} {arg['dtype']}: counts equal {torch.equal(cnt, cnt_ref)}, rel "
                                     f"{err:.3e} against the bf16 plain version (<= 5e-2); from the fp32 plain "
                                     f"version the kernel {e32:.3e}, the bf16 plain version {p32:.3e}")
                w32, wp32 = far.get(name, (0.0, 0.0))
                far[name] = (max(w32, e32), max(wp32, p32))
            elif name == "banded_maxpool_fused":
                cin = arg["s_feats"].shape[-1]
                out, ref = kern(**arg), plain(**arg)
                err = float((out != ref).sum())
                if err:
                    raise PhaseError(f"{name} C {cin} M {arg['q_points'].shape[1]}: {err:.0f} mismatches")
            elif name == "point_group_norm_fused":
                cin = arg["x"].shape[-1]
                mean_gap, rstd_gap, same, bad = point_norm_gaps(**arg)
                err = max(mean_gap, rstd_gap)
                if err > 1e-5 or not same or bad:
                    raise PhaseError(f"{name} x {tuple(arg['x'].shape)}: statistics gap {err:.2e} (<= 1e-5), the "
                                     f"same bits on two launches {same}, apply mismatches {bad}")
            elif name == "fused_attention":
                q, k, v = arg["q"], arg["k"], arg["v"]
                cin = q.shape[-1]
                out = kern(q, k, v)
                err = (out.float() - full_attention(q.float(), k.float(), v.float())).abs().max().item()
                excess = bf16_excess(out, full_attention(q, k, v))
                if excess > ATTN_BF16_EXCESS:
                    raise PhaseError(f"attention q {tuple(q.shape)}: abs {err:.2e}, beyond bf16's rounding "
                                     f"{excess:.2e} (<= {ATTN_BF16_EXCESS:.0e})")
            else:
                raise PhaseError(f"{name} is not on the serving forward's path")
            n, worst, wide = seen.get(name, (0, 0.0, 0))
            seen[name] = (n + 1, max(worst, err), max(wide, cin))
    what = {"banded_kpconv_fused": ("#1", "rel"), "banded_kpconv_aggregate_fused": ("#2", "rel"),
            "banded_maxpool_fused": ("#3", "mismatches"), "fused_attention": ("#4", "abs"),
            "point_group_norm_fused": ("#18", "statistics gap")}
    return "each call against its plain version on its own inputs: " + "; ".join(
        f"{what[k][0]} x{n} (widest C {wide}) worst {what[k][1]} {worst:.2e}"
        + (f" (from the fp32 plain version: kernel {far[k][0]:.2e}, bf16 plain {far[k][1]:.2e})" if k in far else "")
        for k, (n, worst, wide) in seen.items())


def variants(device, seed, smi_line):
    """Two bf16 serving requests at B = 8 through make_eval_body for each
    configuration of VARIANTS (the serving configuration otherwise): the
    launches per forward follow JAX's dispatch (fused_contraction_fits at
    the configuration's K decides #1 against #2 plus a matmul; #4 under
    'pallas' only), finite outputs, finite poses wherever RANSAC
    succeeded; ms a request.  Then every kernel call of a third request on
    the first request's frames is held against its plain version on its
    own inputs (check_recorded_calls)."""
    import torch

    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
    from cofii2p_tpu_torch.models.kpconv import KPConv
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.ops.kpconv_kernel import fused_contraction_fits
    from cofii2p_tpu_torch.utils.convert import randomize
    from cofii2p_tpu_torch.utils.kernel_bench import recording, serve_config

    # eager bodies (the graphs phase replays these configurations): every
    # kernel call counted and recorded, as a forward alone makes it
    for what, over in VARIANTS:
        cfg = serve_config().replace(**over)
        model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(device).eval()
        convs = [m.weights.shape[1:] for m in model.pc_encoder.modules() if isinstance(m, KPConv)]
        fits = sum(fused_contraction_fits(cfg.kernel_size, ci, co, cfg.kpconv_tile, 2) for ci, co in convs)
        want = {name: 0 for name in KERNELS}
        want.update(kpconv_fused=fits, kpconv_aggregate=len(convs) - fits, maxpool=4,
                    attention=16 if cfg.attention == "pallas" else 0,
                    point_norm=NORM_SITES if cfg.norm == "gn" else 0)
        run = make_eval_body(cfg, model, stages=())
        gen = torch.Generator(device).manual_seed(seed)
        ms, succ, calls = [], 0, []
        for i in range(2):
            hb = frames(cfg, BATCH, device, start=i * BATCH)
            torch.cuda.synchronize()
            before = read_launches()
            t0 = time.perf_counter()
            out = run(hb, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per = {k: v - before[k] for k, v in read_launches().items()}
            if per != dict(want, ransac_pnp=1):
                raise PhaseError(f"variants, {what}: request {i} launched {per}, expected {want}")
            for field, val in out._asdict().items():
                if field not in ("R", "t") and val.is_floating_point() and not torch.isfinite(val).all():
                    raise PhaseError(f"variants, {what}: request {i} field {field} has non-finite values")
            finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
            if not finite[out.success].all():
                raise PhaseError(f"variants, {what}: request {i} has a non-finite pose where RANSAC succeeded")
            succ += int(out.success.sum())
        say("variants", f"{what}: 2 bf16 requests x {BATCH} frames (160x512, 20480 pts) through make_eval_body: "
            + ", ".join(f"{x:.1f}" for x in ms) + " ms a request; launches/forward "
            + ", ".join(f"{k} {v}" for k, v in want.items() if v) + f", every other kernel 0; RANSAC success "
            f"{succ}/{2 * BATCH}, finite poses; card {smi_line}")
        with recording(calls):  # a third request, whose launches the recorder counts
            run(frames(cfg, BATCH, device), gen)
        torch.cuda.synchronize()
        if len(calls) != sum(want.values()):
            raise PhaseError(f"variants, {what}: {len(calls)} kernel calls recorded, {sum(want.values())} launched")
        try:
            say("variants", f"{what}: " + check_recorded_calls(calls))
        except PhaseError as e:
            raise PhaseError(f"variants, {what}: {e}") from None
        del model, run, calls
        torch.cuda.empty_cache()


def loader_reading(dataset, cfg):
    """The loader alone, no model: BatchLoader over the dataset, B = 8, the
    configuration's worker threads, every batch of one epoch; returns
    (frames/s, seconds, frames)."""
    from cofii2p_tpu_torch.data.loader import BatchLoader

    t0 = time.perf_counter()
    count = sum(len(b["index"]) for b in BatchLoader(dataset, BATCH, num_workers=cfg.num_workers).epoch(0))
    dt = time.perf_counter() - t0
    return count / dt, dt, count


def check_fed_steps(phase, steps, n_steps):
    """Per-step launch counts of a loader-fed train.main run against
    PER_STEP, finite metrics; returns the line of its readings: the steps'
    own ms, and frames/s of steps 2..n fed by the loader (end of step 1 to
    end of step n, the wait for each batch included)."""
    if len(steps) != n_steps:
        raise PhaseError(f"{phase}: {len(steps)} steps ran, expected {n_steps}")
    for i, (_, per_step, metrics, _) in enumerate(steps):
        for name, want in PER_STEP.items():
            if per_step[name] != want:
                raise PhaseError(f"{phase}: step {i} launched {name} {per_step[name]} times, expected {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise PhaseError(f"{phase}: step {i} metrics not finite: {metrics}")
    steady = sum(dt for dt, *_ in steps[1:]) * 1e3 / (n_steps - 1)
    fed = BATCH * (n_steps - 1) / (steps[-1][3] - steps[0][3])
    return (f"{n_steps} steps x {BATCH} frames through train.main: losses "
            + " -> ".join(f"{m['loss']:.4f}" for _, _, m, _ in steps) + "; ms/step "
            + ", ".join(f"{dt * 1e3:.1f}" for dt, *_ in steps) + f"; steps 2-{n_steps} {steady:.1f} ms "
            f"({BATCH * 1e3 / steady:.2f} frames/s), fed by the loader {fed:.2f} frames/s; launches/step "
            + ", ".join(f"{k} {v}" for k, v in steps[-1][1].items() if v))


def check_eval_all_run(phase, batches, per_forward, n_frames, workdir, dataset):
    """What an eval_all.main run with ``--eval_path <workdir>`` from
    ``workdir`` must leave: every frame in full batches of BATCH, launches
    per batch as ``body_launches`` gives them for ``per_forward`` (the
    body replays its stages as CUDA graphs), finite poses wherever RANSAC
    succeeded, one dump a frame with the reference's keys and both error arrays;
    returns the number of dumps."""
    import glob

    import numpy as np
    import torch

    if len(batches) != n_frames // BATCH or any(b[3] != BATCH for b in batches):
        raise PhaseError(f"{phase}: batches of {[b[3] for b in batches]} frames ran, expected {n_frames // BATCH} "
                         f"of {BATCH}")
    for i, (_, per, out, *_) in enumerate(batches):
        for name, want in body_launches(per_forward, i == 0).items():
            if name == "ransac_pnp" and i == 0:
                want = RANSAC_AT_CAPTURE  # the first batch captures the RANSAC graph
            if per[name] != want:
                raise PhaseError(f"{phase}: batch {i} launched {name} {per[name]} times, expected {want}")
        finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
        if not finite[out.success].all():
            raise PhaseError(f"{phase}: batch {i} has a non-finite pose where RANSAC succeeded")
    dumps = sorted(glob.glob(os.path.join(workdir, dataset, "*", "*.npy")))
    if len(dumps) != n_frames:
        raise PhaseError(f"{phase}: {len(dumps)} per-frame dumps, expected {n_frames}")
    for path in dumps:
        keys = set(np.load(path, allow_pickle=True).item())
        if keys != T7_DUMP_KEYS:
            raise PhaseError(f"{phase}: {os.path.basename(path)} holds {sorted(keys)}, expected {sorted(T7_DUMP_KEYS)}")
    for arr in (f"{dataset}_t_error.npy", f"{dataset}_r_error.npy"):
        if not os.path.exists(os.path.join(workdir, arr)):
            raise PhaseError(f"{phase}: {arr} was not written")
    return len(dumps)


def fed_eval_line(batches):
    """The readings of a loader-fed eval_all.main run: the median ms of
    batches 2.. and their frames/s fed by the loader (end of batch 1 to
    end of the last, the wait for each batch included)."""
    ms = sorted(b[0] * 1e3 for b in batches[1:])
    med = (ms[(len(ms) - 1) // 2] + ms[len(ms) // 2]) / 2
    fed = BATCH * (len(batches) - 1) / (batches[-1][4] - batches[0][4])
    succ = sum(int(b[2].success.sum()) for b in batches)
    return ("batches " + ", ".join(f"{b[0] * 1e3:.1f}" for b in batches) + f" ms, median of batches "
            f"2-{len(batches)} {med:.1f} ms ({BATCH * 1e3 / med:.2f} frames/s), fed by the loader {fed:.2f} "
            "frames/s; launches/batch at the capture "
            + ", ".join(f"{k} {batches[0][1][k] // AT_CAPTURE}" for k in PER_EVAL_FORWARD if batches[0][1][k])
            + f"; RANSAC success {succ}/{BATCH * len(batches)}, finite poses")


def real_data(device, seed, smi_line, dataset):
    """The on-disk data path: a fixture tree in the real layout at the real
    sizes (cofii2p_tpu_torch/data/fixtures.py), written from the seed into
    a temporary directory; the loader alone over its val split; then
    train.main and eval_all.main on it without --synthetic (kitti: 4
    steps, val at step 4, and the trained checkpoint through eval_all;
    nuscenes: 2 steps, which run the has_normals=False supervision, and
    eval_all on seeded random weights), launches per step and per eval
    batch as the synthetic paths' (PER_STEP, PER_EVAL_FORWARD)."""
    import tempfile

    import torch

    from cofii2p_tpu_torch import native
    from cofii2p_tpu_torch import train as train_cli
    from cofii2p_tpu_torch.config import get_config
    from cofii2p_tpu_torch.data import fixtures
    from cofii2p_tpu_torch.evaluation import eval_all
    from cofii2p_tpu_torch.train import build_dataset
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint

    t0 = time.perf_counter()
    native.lib()  # g++ builds the host ops on first use
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix=f"{dataset}_") as tmp:
        tree = os.path.join(tmp, dataset)
        t0 = time.perf_counter()
        points = FIXTURE_POINTS[dataset]
        if dataset == "kitti":
            fixtures.write_kitti_tree(tree, seed, KITTI_FIXTURE_FRAMES, points)
            n_steps, n_val, hw = TRAIN_STEPS, 2 * (KITTI_FIXTURE_FRAMES[9] + KITTI_FIXTURE_FRAMES[10]), \
                fixtures.KITTI_IMAGE_HW
        else:
            fixtures.write_nuscenes_tree(tree, seed, NUSCENES_FIXTURE_FRAMES, points)
            n_steps, n_val, hw = NUSCENES_TRAIN_STEPS, NUSCENES_FIXTURE_FRAMES["test"], fixtures.NUSCENES_IMAGE_HW
        write_s = time.perf_counter() - t0
        cfg = get_config(dataset).replace(data_path=tree)
        fps, dt, count = loader_reading(build_dataset(dataset, cfg, "val", False), cfg)
        say(dataset, f"fixture tree ({points}-point clouds, {hw[0]}x{hw[1]} images) written in {write_s:.1f} s, "
            f"host ops built in {build_s:.1f} s; the loader alone (BatchLoader, B={BATCH}, {cfg.num_workers} threads, "
            f"no model): {count} val frames in {dt:.2f} s, {fps:.2f} frames/s; card {smi_line}")

        steps, captured = [], {}
        argv = [dataset, f"data_path={tree}", f"root_path={tmp}", "--steps", str(n_steps), "--batch_size", str(BATCH)]
        if dataset == "kitti":
            argv.append(f"val_freq={n_steps}")
        reset_launches()
        with recording_train_steps(steps, captured):
            save_dir = train_cli.main(argv)
        if captured["has_normals"] != (dataset == "kitti"):
            raise PhaseError(f"{dataset}: train.main ran has_normals={captured['has_normals']}")
        say(dataset, check_fed_steps(dataset, steps, n_steps) + f"; card {smi_line}")
        del captured
        torch.cuda.empty_cache()

        ckpt = latest_checkpoint(save_dir) if dataset == "kitti" else "none"
        if ckpt is None:
            raise PhaseError(f"{dataset}: no checkpoint under {save_dir}")
        batches, workdir = [], os.path.join(tmp, "eval")
        os.makedirs(workdir)
        reset_launches()
        with recording_eval_batches(batches, workdir):
            eval_all.main([ckpt, dataset, f"data_path={tree}", "--batch_size", str(BATCH), "--eval_path", workdir])
        dumps = check_eval_all_run(dataset, batches, PER_EVAL_FORWARD, n_val, workdir, dataset)
        what = "the trained checkpoint" if dataset == "kitti" else "seeded random weights"
        say(dataset, f"eval_all.main on {what}, {n_val} frames x B={BATCH}: {dumps} dumps and both error arrays; "
            + fed_eval_line(batches) + f"; card {smi_line}")
        torch.cuda.empty_cache()


# serve_compact: the serving config with compacted formulations on the
# support levels its windows leave static (a window meeting a compacted
# plan raises): encoder1_1's and encoder1_2's convs (level 0 self),
# encoder2_1's conv and shortcut (level 1 <- 0), encoder5_2's and 5_3's
# convs (level 4 self) compacted, so #1 runs the other 9 convs and #3 the
# other 3 shortcuts
SERVE_COMPACT = dict(maxpool_compact_plan=(128,), aggregate_compact_plan=(128, 0, 0, 0, 128))
PER_COMPACT_FORWARD = {"kpconv_fused": 9, "maxpool": 3, "attention": 16, "residual_fused": 0, "knn_tau": 0,
                       "point_norm": NORM_SITES, "window_starts": WINDOW_PAIRS}
COMPACT_REQUESTS = 3
# t7_compact: every conv and shortcut of the `.t7` config compacted at
# k = knn_k: no tau (#5) and no banded kernel in the forward, #4 alone
T7_COMPACT = dict(maxpool_compact_plan=(128,) * 5, aggregate_compact_plan=(1,) * 5)
PER_T7_COMPACT_FORWARD = {**{name: 0 for name in KERNELS}, "attention": 16, "point_norm": NORM_SITES}
# train_compact: encoder5_1's shortcut and the convs on support levels 3
# and 4 (encoder4_2, 4_3, 5_1, 5_2, 5_3) compacted; the other 9 convs on
# #2 (8 of them with a #9 backward), 3 shortcuts on #3, #12 and #13
TRAIN_COMPACT = ["maxpool_compact_plan=0,0,0,128", "aggregate_compact_plan=0,0,0,128,128"]
PER_COMPACT_STEP = {"kpconv_aggregate": 9, "kpconv_transpose": 8, "maxpool": 3, "maxpool_count": 3,
                    "maxpool_bwd": 3, "knn_tau": 0, "kpconv_transpose_dyn": 0, "maxpool_bwd_dyn": 0, **NOT_TRAINED}
COMPACT_STEPS = 2
FLOPS_LINES = ("params:", "end-to-end pipeline:", "network forward:", "network flops/frame:",
               "network activations/frame:", "network peak memory:", "pnp-ransac alone:")


def check_pose_outputs(phase, outs, cfg, device):
    """Finite network outputs, and finite proper rotations wherever RANSAC
    succeeded, of each B-frame output; returns the non-finite pose count."""
    import torch

    eye = torch.eye(3, device=device)
    nonfinite_pose = 0
    for i, out in enumerate(outs):
        for field, val in out._asdict().items():
            if field not in ("R", "t") and val.is_floating_point() and not torch.isfinite(val).all():
                raise PhaseError(f"{phase}: batch {i} field {field} has non-finite values")
        finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
        if not finite[out.success].all():
            raise PhaseError(f"{phase}: batch {i} has a non-finite pose where RANSAC succeeded")
        nonfinite_pose += int((~finite).sum())
        orth = (out.R[finite].transpose(-1, -2) @ out.R[finite] - eye).abs().amax().item() if finite.any() else 0.0
        if orth > 1e-3:
            raise PhaseError(f"{phase}: batch {i} |R^T R - I| = {orth:.2e} > 1e-3")
        if out.R.shape != (BATCH, 3, 3) or out.fine_xy.shape != (BATCH, cfg.num_superpoints, 2):
            raise PhaseError(f"{phase}: batch {i} shapes {out.R.shape}, {out.fine_xy.shape}")
    return nonfinite_pose


def timed_batches(phase, cfg, model, device, seed, n, per_forward):
    """A warm-up and ``n`` timed B-frame batches through make_eval_body:
    launches a forward as ``per_forward`` at the warm-up's capture, none in
    the replayed batches, outputs checked; returns
    (ms a batch, peak GiB, the first timed batch, RANSAC successes)."""
    import torch

    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body

    run = make_eval_body(cfg, model)
    batches = [frames(cfg, BATCH, device, start=i * BATCH) for i in range(n + 1)]
    gen = torch.Generator(device).manual_seed(seed)
    reset_launches()
    run(batches[0], gen)
    torch.cuda.synchronize()
    captured = read_launches()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [run(hb, gen) for hb in batches[1:]]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    for name, want in per_forward.items():
        at_capture = RANSAC_AT_CAPTURE if name == "ransac_pnp" else AT_CAPTURE * want
        if captured[name] != at_capture or launches[name]:
            raise PhaseError(f"{phase}: {name} launched {captured[name]} times at the capture and {launches[name]} "
                             f"in {n} replayed forwards, expected {at_capture} at the capture, then none")
    check_pose_outputs(phase, outs, cfg, device)
    return ms, peak, batches[1], sum(int(o.success.sum()) for o in outs)


@contextlib.contextmanager
def block_inputs(model, names, sink):
    """While open, sink[name] holds the first three positional inputs
    (features, query points, support points) of the first call of each
    named module of model.pc_encoder ('encoder2_1', 'encoder1_2.KPConv')."""
    handles = [model.pc_encoder.get_submodule(n).register_forward_pre_hook(
        lambda mod, args, _n=n: sink.setdefault(_n, args[:3])) for n in names]
    try:
        yield sink
    finally:
        for h in handles:
            h.remove()


def serve_compact(device, seed, smi_line):
    """The serving config with SERVE_COMPACT: timed requests, then the
    compacted maxpool and aggregation held against #3 and #2 on the
    forward's own inputs, and the drift against the plain versions."""
    import torch

    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize
    from cofii2p_tpu_torch.utils.kernel_bench import serve_config

    cfg = serve_config().replace(**SERVE_COMPACT)
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(device).eval()
    ms, peak, hb, succ = timed_batches("serve_compact", cfg, model, device, seed, COMPACT_REQUESTS,
                                       PER_COMPACT_FORWARD)
    say("serve_compact", f"{COMPACT_REQUESTS} requests x {BATCH} frames, bf16 w192 with maxpool_compact_plan "
        f"{cfg.maxpool_compact_plan}, aggregate_compact_plan {cfg.aggregate_compact_plan}: {ms:.1f} ms/request "
        f"({BATCH * 1e3 / ms:.2f} frames/s), peak {peak:.2f} GiB; launches/forward "
        + ", ".join(f"{k} {v}" for k, v in PER_COMPACT_FORWARD.items())
        + f"; RANSAC success {succ}/{COMPACT_REQUESTS * BATCH}; card {smi_line}")
    try:
        say("serve_compact", check_compact_against_kernels(cfg, model, hb, device, seed))
        say("serve_compact", check_serve_drift(cfg, model, hb, device, seed, PER_COMPACT_FORWARD))
    except PhaseError as e:
        raise PhaseError(f"serve_compact: {e}") from None
    del model
    torch.cuda.empty_cache()


def check_compact_against_kernels(cfg, model, hb, device, seed):
    """On one B=8 forward's own inputs: encoder2_1's compacted shortcut
    bit-equal to #3 on every query whose in-reach count is <= k, and
    encoder1_2's compacted aggregation, in fp32, within 1e-4 rel of #2 on
    those queries, its counts (the uncapped in-reach count) equal to #2's
    everywhere."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.ops.banded import banded_compact_aggregate, banded_compact_maxpool, banded_pair_count
    from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_aggregate_fused
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_fused

    draws = make_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    with torch.no_grad(), block_inputs(model, ("encoder2_1", "encoder1_2.KPConv"), {}) as got:
        model(batch)
        blk, conv = model.pc_encoder.encoder2_1, model.pc_encoder.encoder1_2.KPConv
        f, q, s = got["encoder2_1"]
        k = cfg.maxpool_compact_plan[0]
        compact = banded_compact_maxpool(f, q, s, blk.r_active, k, blk.tile, blk.band_width)
        pooled = banded_maxpool_fused(f, q, s, blk.r_active, blk.tile, blk.band_width)
        under = banded_pair_count(q, s, blk.r_active, blk.tile, blk.band_width) <= k
        if not under.any() or not torch.equal(compact[under], pooled[under]):
            raise PhaseError(f"the compacted maxpool differs from #3 on queries under the cap ({int(under.sum())})")
        f, q, s = got["encoder1_2.KPConv"]
        ka = cfg.aggregate_compact_plan[0]
        args = (f.float(), q, s, conv.radius, conv.sigma, conv.kernel_size)
        w_c, c_c = banded_compact_aggregate(*args, ka, conv.tile, conv.band_width)
        w_k, c_k = banded_kpconv_aggregate_fused(*args, conv.tile, conv.band_width)
        under_a = c_k <= ka
        if not torch.equal(c_c, c_k):
            raise PhaseError(f"the compacted aggregation's counts differ from #2's at {int((c_c != c_k).sum())}")
        err = rel_err(w_c[under_a], w_k[under_a])
        if not under_a.any() or err > 1e-4:
            raise PhaseError(f"the compacted aggregation is {err:.2e} rel from #2 under the cap (<= 1e-4)")
    torch.cuda.synchronize()
    return (f"on the forward's own inputs: encoder2_1's compacted shortcut (k {k}, C {pooled.shape[-1]}) "
            f"bit-equal to #3 on the {under.float().mean():.1%} of queries with <= {k} in reach; encoder1_2's compacted "
            f"aggregation (k {ka}, fp32) counts equal to #2's, rel {err:.2e} on the {under_a.float().mean():.1%} under "
            "the cap")


def t7_compact(device, seed, smi_line):
    """The `.t7` config with T7_COMPACT: timed forwards that launch #4
    alone (no tau), then each strided shortcut's compacted k-NN maxpool
    held against #8 under #5's tau on the same inputs."""
    import torch

    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
    from cofii2p_tpu_torch.utils.kernel_bench import t7_model

    cfg = reference_ckpt_config(KITTIConfig(), [], device).replace(**T7_COMPACT)
    model = t7_model(cfg, seed, device)
    ms, peak, hb, succ = timed_batches("t7_compact", cfg, model, device, seed, 2, PER_T7_COMPACT_FORWARD)
    say("t7_compact", f"2 batches x {BATCH} frames, fp32 {cfg.kpconv_impl} (per-layer kernel points) with every conv "
        f"and shortcut compacted at k = {cfg.neighbor_num}: {ms:.1f} ms/batch ({BATCH * 1e3 / ms:.2f} frames/s), peak "
        f"{peak:.2f} GiB; launches/forward attention 16, knn_tau 0, every other kernel 0; RANSAC success {succ}/"
        f"{2 * BATCH}; card {smi_line}")
    try:
        say("t7_compact", check_t7_compact_maxpool(cfg, model, hb, device, seed))
    except PhaseError as e:
        raise PhaseError(f"t7_compact: {e}") from None
    del model
    torch.cuda.empty_cache()


def check_t7_compact_maxpool(cfg, model, hb, device, seed):
    """Outside the timed forwards: each strided shortcut's inputs through
    #5 (tau) and #8 (the tau maxpool), and through the compacted k-NN
    maxpool: bit-equal on every query whose tau admits exactly k rows,
    i.e. with no tie or near-tie (within tau's rel 1e-5 pad,
    cofii2p_tpu/ops/banded.py:840) at the k-th distance."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.ops.banded import banded_compact_maxpool, banded_pair_count
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_tau
    from cofii2p_tpu_torch.ops.tau_kernel import banded_knn_tau_kernel

    draws = make_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    names = [f"encoder{stage}_1" for stage in range(2, 6)]
    k = cfg.neighbor_num
    shares = []
    with torch.no_grad(), block_inputs(model, names, {}) as got:
        model(batch)
        for name in names:
            blk = model.pc_encoder.get_submodule(name)
            f, q, s = got[name]
            tau = banded_knn_tau_kernel(q, s, k, blk.tile, blk.band_width)
            pooled = banded_maxpool_tau(f, q, s, tau, blk.tile, blk.band_width)
            compact = banded_compact_maxpool(f, q, s, 0.0, k, blk.tile, blk.band_width, knn=True)
            exact = banded_pair_count(q, s, None, blk.tile, blk.band_width, tau=tau) == k
            if not exact.any() or not torch.equal(compact[exact], pooled[exact]):
                raise PhaseError(f"{name}: the compacted k-NN maxpool differs from #8 on queries without a tie")
            shares.append(float(exact.float().mean()))
    torch.cuda.synchronize()
    return ("the 4 strided shortcuts' inputs through #5 and #8 and through the compacted k-NN maxpool (k "
            f"{k}): bit-equal on every query without a tie or near-tie at the k-th distance ("
            + ", ".join(f"{x:.1%}" for x in shares) + " of queries)")


def train_compact(device, seed, smi_line):
    """`train kitti --synthetic` with TRAIN_COMPACT for COMPACT_STEPS steps
    through train.main: launches a step as PER_COMPACT_STEP, finite
    losses, parameters moved; ms a step and peak memory."""
    import shutil
    import tempfile

    import torch

    from cofii2p_tpu_torch import train as train_cli

    steps, captured = [], {}
    root = tempfile.mkdtemp(prefix="train_compact_", dir=OUT_DIR)
    argv = ["kitti", f"root_path={root}", "val_freq=1000", "--synthetic", "--steps", str(COMPACT_STEPS),
            "--batch_size", str(BATCH), "--synthetic_frames", str(COMPACT_STEPS * BATCH), *TRAIN_COMPACT]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        with recording_train_steps(steps, captured):
            train_cli.main(argv)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(steps) != COMPACT_STEPS:
        raise PhaseError(f"train_compact: {len(steps)} steps ran, expected {COMPACT_STEPS}")
    for i, (_, per_step, metrics, _) in enumerate(steps):
        bad = {name: per_step[name] for name, want in PER_COMPACT_STEP.items() if per_step[name] != want}
        if bad:
            raise PhaseError(f"train_compact: step {i} launched {bad}, expected {PER_COMPACT_STEP}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise PhaseError(f"train_compact: step {i} metrics not finite: {metrics}")
    model = captured["model"]
    moved = sum(int(not torch.equal(p.detach(), captured["before"][n])) for n, p in model.named_parameters())
    del model, captured
    torch.cuda.empty_cache()
    if moved == 0:
        raise PhaseError("train_compact: no parameter changed")
    ms = [dt * 1e3 for dt, *_ in steps]
    say("train_compact", f"{COMPACT_STEPS} steps x {BATCH} frames, fp32 static bands with " + ", ".join(TRAIN_COMPACT)
        + " through train.main: losses " + " -> ".join(f"{m['loss']:.4f}" for _, _, m, _ in steps)
        + "; ms/step " + ", ".join(f"{x:.1f}" for x in ms) + f" ({BATCH * 1e3 / ms[-1]:.2f} frames/s at the last); "
        f"peak {peak:.2f} GiB; launches/step " + ", ".join(f"{k} {v}" for k, v in steps[-1][1].items() if v)
        + f"; {moved} parameter tensors moved; card {smi_line}")


def train_dp(device, seed, smi_line):
    """One `train kitti --synthetic` step of B=8 through train.main alone,
    then the same under a world-size-1 NCCL process group on a FileStore
    (the data-parallel path: gradients all-reduced, BatchNorm statistics
    all-reduced, metrics reduced): the updated parameters and buffers
    equal bit for bit.  Both run under torch.use_deterministic_algorithms:
    the step's plain PyTorch backward adds by atomics (two identical steps
    differ in the last bits of 218 of 332 gradient tensors on the card),
    so only deterministic algorithms make a bit comparison mean anything."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from cofii2p_tpu_torch import train as train_cli

    root = tempfile.mkdtemp(prefix="train_dp_", dir=OUT_DIR)
    argv = ["kitti", f"root_path={root}", "val_freq=1000", "--synthetic", "--steps", "1", "--batch_size", str(BATCH),
            "--synthetic_frames", str(BATCH)]
    states, metrics, ms = [], [], []
    deterministic = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        for grouped in (False, True):
            steps, captured = [], {}
            if grouped:
                dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0,
                                        world_size=1)
            try:
                with recording_train_steps(steps, captured):
                    train_cli.main(argv)
            finally:
                if grouped:
                    dist.destroy_process_group()
            states.append({k: v.detach().clone() for k, v in captured["model"].state_dict().items()})
            metrics.append(steps[0][2])
            ms.append(steps[0][0] * 1e3)
            del captured
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(deterministic)
        shutil.rmtree(root, ignore_errors=True)
    differ = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    if differ or metrics[0] != metrics[1]:
        raise PhaseError(f"train_dp: under the world-size-1 group {len(differ)} tensors differ ({differ[:5]}), "
                         f"metrics {metrics[1]} against {metrics[0]}")
    say("train_dp", f"one step x {BATCH} frames through train.main alone ({ms[0]:.1f} ms) and under a world-size-1 NCCL "
        f"group ({ms[1]:.1f} ms), deterministic algorithms: all {len(states[0])} parameters and buffers bit-equal, metrics equal (loss "
        f"{metrics[0]['loss']:.4f}); card {smi_line}")


def flops(device, seed, smi_line):
    """get_flops_fps on the serving config at B=8: its lines, each printed
    here (none of them the last line of the run)."""
    import gc
    import io

    import torch

    from cofii2p_tpu_torch.evaluation import get_flops_fps

    argv = ["", "kitti", "--batch_size", str(BATCH), "compute_dtype=bfloat16", "kpconv_dynamic_plan=0,192,192,192,0",
            "kpconv_dynamic_plan_self=0,0,192,192,0", "attention=pallas"]
    gc.collect()  # the peak it reads counts every tensor still allocated
    torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        get_flops_fps.main(argv)
    lines = buf.getvalue().splitlines()
    missing = [h for h in FLOPS_LINES if not any(line.startswith(h) for line in lines)]
    if missing:
        raise PhaseError(f"flops: get_flops_fps printed no {missing}: {lines}")
    for line in lines:
        say("flops", line)
    say("flops", f"get_flops_fps on the serving config (bf16 w192, fused attention), B={BATCH}; card {smi_line}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=REQUESTS, help="timed requests of each serve phase")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one serving request with torch.profiler into chiprun_out/")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cofii2p_tpu_torch.ops import cuda_lib

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi_line}; TF32 off")

    t = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.lib()
    os.makedirs(OUT_DIR, exist_ok=True)
    if cuda_lib.build_log:
        with open(os.path.join(OUT_DIR, "nvcc_build.log"), "w") as fh:
            fh.write(cuda_lib.build_log)
    say("build", f"{os.path.relpath(path, ROOT)} in {time.perf_counter() - t:.1f} s")

    tally = Tally()
    gen = torch.Generator().manual_seed(args.seed)
    launches, seconds = {}, {}

    def run(phase, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        seconds[phase] = time.perf_counter() - t0
        return res

    try:
        if "kernels" in phases:
            run("kernels", check_kernels, device, gen, tally)
        if "fp32" in phases:
            run("fp32", check_fp32_path, device, args.seed)
        if "grad" in phases:
            run("grad", check_grad, device, args.seed)
        if "pose" in phases:
            run("pose", check_pose, device, gen, tally)
        if "serve" in phases:
            served, _, _ = run("serve", serve, device, args.seed, smi_line, args.profile, False, args.requests)
            launches.update({k: served[k] for k in SERVE_KERNELS})
        if "graphs" in phases:
            run("graphs", graphs, device, args.seed, smi_line, args.requests)
        if "serve_resfuse" in phases:
            served, _, _ = run("serve_resfuse", serve, device, args.seed, smi_line, False, True, args.requests)
            launches.update({k: served[k] for k in SERVE_RESFUSE_KERNELS})
        if "train" in phases:
            trained = run("train", train, device, args.seed, smi_line)
            launches.update({k: trained[k] for k in TRAIN_KERNELS})
        if "t7" in phases:
            evaluated, _, _ = run("t7", t7, device, args.seed, smi_line)
            launches.update({k: evaluated[k] for k in T7_KERNELS})
        for phase, names in (("train_fast", FAST_KERNELS), ("train_knn", KNN_TRAIN_KERNELS)):
            if phase in phases:
                trained = run(phase, train, device, args.seed, smi_line, phase)
                launches.update({k: trained[k] for k in names})
        for dataset in ("kitti", "nuscenes"):
            if dataset in phases:
                run(dataset, real_data, device, args.seed, smi_line, dataset)
        if "t7_gather" in phases:
            run("t7_gather", t7_gather, device, args.seed, smi_line)
        if "train_gather" in phases:
            run("train_gather", train_gather, device, args.seed, smi_line)
        if "variants" in phases:
            run("variants", variants, device, args.seed, smi_line)
        for phase, fn in (("serve_compact", serve_compact), ("t7_compact", t7_compact),
                          ("train_compact", train_compact), ("train_dp", train_dp), ("flops", flops)):
            if phase in phases:
                run(phase, fn, device, args.seed, smi_line)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say("time", ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    if set(phases) != set(PHASES):
        say("done", f"phases {','.join(phases)} passed; the result lines need every phase")
        return 0
    results = tally.results()
    summary = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name], **results[name])
        for name in KERNELS
    ]}
    print(json.dumps(summary))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
