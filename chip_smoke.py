#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and `.t7` eval paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,serve --requests 3

Phases (each prints one or more lines; any failure exits non-zero before
the last line):
  device   require CUDA; print the nvidia-smi name and power limit; TF32 off
  build    compile cofii2p_tpu_torch/csrc/*.cu with nvcc, one process per
           source (first use, cached by source hash under
           build/cofii2p_tpu_torch/)
  kernels  each CUDA kernel against its plain PyTorch version: the serving
           kernels at the serving shapes, fp32 and bf16 (the fused KPConv
           at lvl0 4->64 on fp32 features and 32->32, lvl1 <- lvl0
           32->64, lvl2 static and w192, lvl4 512->512; the attention with
           serving's normalised queries and with randn ones, its bf16
           output within bf16's rounding of the fp32 plain version on the
           same inputs plus 5e-4); the training
           kernels (aggregate, transposed aggregate, tie count, maxpool
           backward) at the trainer's fp32 shapes, B=8, on clouds with
           duplicated points so that maxima tie, the aggregate (tensor
           cores, fp32 by 3xTF32) also on encoder4_2's 2176-row band; the
           k-NN kernels (tau,
           tau KPConv fused and aggregate, tau maxpool) at the `.t7`
           path's fp32 shapes, B=8, on the same clouds, so that k-th and
           (k+1)-th distances and maxima tie: tau and the maxpool bit-equal,
           the KPConvs (tensor cores, fp32 by 3xTF32) at every width of the
           FPN, on bands of one membership segment and of two (2176 and
           2304 rows), with equal active-row counts; the backward kernels of
           `train --fast` (window transpose, window maxpool backward, the
           tie count on windows) on the w256 windows and of `banded_knn`
           training (tau transpose on the tensor cores, tau maxpool
           backward, the tie count by tau) on the k-NN pairs' static bands:
           tie counts bit-equal, transposes rel <= 1e-4, the tau transpose
           the same bits on two launches, maxpool backwards rel <= 1e-5,
           the window scatter bit-equal on the kernel's own stack; the fused residual
           band pass (#16) at the four strided blocks' serving shapes (bf16,
           w192) and the three fp32 static ones it takes, on clouds with
           duplicated points: counts equal and shortcuts bit-equal to the
           plain version and to the pair it fuses (#1 then #3), the conv
           bit-equal to #1's and within #1's thresholds of the plain
           version, with the pair's time beside the kernel's; the kernel's
           and the plain version's time (CUDA events) and the least time
           the card could take for the same work (the larger of bytes over
           3.35 TB/s and operations over the peak rate of their type)
  fp32     the whole forward at B=1 in fp32 through the kernels and through
           the plain versions: FPN and transformer outputs agree
  grad     one fp32 train step at B=1 on a KITTI-scale frame through the
           kernels and through the plain versions under autograd
           (kpconv_kernel='xla'), same weights and draws: losses agree to
           1e-4 and every parameter gradient to 1e-3 (rms-floored)
  pose     the pipeline's EPnP-RANSAC at serving size (8 frames, 1280
           correspondences, 512 hypotheses) on scenes of known pose with
           outliers and masked rows: it recovers the pose
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
           weights, frames and draws), tools/window_drift.py's four
           readings, each within twice the CUDA-core kernels' reading
           plus one point (SERVE_DRIFT_LIMITS).
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
           frames/s and peak memory.
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
The second line before the last is the JSON kernel summary, then the
nvidia-smi name and power limit, then {"ok": true, "device": {...}}.
Long logs go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PHASES = ("device", "build", "kernels", "fp32", "grad", "pose", "serve", "serve_resfuse", "train", "t7", "train_fast",
          "train_knn")
BATCH = 8
REQUESTS = 10  # timed requests a serve phase: a request is ~0.13 s, where host jitter of a few ms shows
TRAIN_STEPS = 4
PER_FORWARD = {"kpconv_fused": 14, "maxpool": 4, "attention": 16, "residual_fused": 0}
# with kpconv_residual_fused: the 4 strided blocks' conv and shortcut in one
# pass each (all fit residual_fused_fits in bf16 at w192), the other 10 convs
PER_RESFUSE_FORWARD = {"residual_fused": 4, "kpconv_fused": 10, "maxpool": 0, "attention": 16}
# the serve phase's drift readings (tools/window_drift.py's four) between
# the kernels and the plain versions, measured with the CUDA-core #1 and #4
# before their tensor-core redesign (H100 80GB HBM3, seed 0); a reading may
# grow to twice that plus one point: 0.01 for a fraction, 1e-2 for the score
SERVE_DRIFT_PARENT = dict(argmax=0.0369, selection=0.0006, fine_cell=0.0625, score=0.01324)
SERVE_DRIFT_LIMITS = {k: 2 * v + 0.01 for k, v in SERVE_DRIFT_PARENT.items()}
# the bf16 attention kernel, beyond bf16's rounding of the fp32 plain
# version on its inputs: the fp32 sums' order and P split into two bf16
# terms (2^-16 relative) leave ~1e-5 at these magnitudes
ATTN_BF16_EXCESS = 5e-4
# launches per train step: 14 KPConvs forward, 13 feature gradients (not
# encoder1_1's, whose input needs none), 4 strided shortcuts forward and
# backward; no fused KPConv and no fused attention while differentiating
NOT_TRAINED = {"kpconv_fused": 0, "attention": 0, "kpconv_fused_tau": 0, "residual_fused": 0}
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
PER_T7_FORWARD = {"knn_tau": 9, "kpconv_fused_tau": 12, "kpconv_aggregate_tau": 2, "maxpool_tau": 4, "attention": 16,
                  "kpconv_fused": 0, "kpconv_aggregate": 0, "maxpool": 0, "residual_fused": 0}
T7_DUMP_KEYS = {"GT_P", "pred_P", "K", "fine_xy", "corr_mask", "object_points", "superpoints_score"}
KERNELS = {
    "kpconv_fused": ("cofii2p_tpu_torch/csrc/kpconv_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:1007"),
    "maxpool": ("cofii2p_tpu_torch/csrc/maxpool.cu", "cofii2p_tpu/ops/maxpool_kernel.py:208"),
    "attention": ("cofii2p_tpu_torch/csrc/attention.cu", "cofii2p_tpu/ops/attention_kernel.py:53"),
    "kpconv_aggregate": ("cofii2p_tpu_torch/csrc/kpconv_tau_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:228"),
    "kpconv_transpose": ("cofii2p_tpu_torch/csrc/kpconv_transpose.cu", "cofii2p_tpu/ops/kpconv_kernel.py:516"),
    "maxpool_count": ("cofii2p_tpu_torch/csrc/maxpool.cu", "cofii2p_tpu/ops/maxpool_kernel.py:315"),
    "maxpool_bwd": ("cofii2p_tpu_torch/csrc/maxpool_bwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:537"),
    "knn_tau": ("cofii2p_tpu_torch/csrc/knn_tau.cu", "cofii2p_tpu/ops/tau_kernel.py:110"),
    "kpconv_aggregate_tau": ("cofii2p_tpu_torch/csrc/kpconv_tau_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:691"),
    "kpconv_fused_tau": ("cofii2p_tpu_torch/csrc/kpconv_tau_mma.cuh", "cofii2p_tpu/ops/kpconv_kernel.py:1212"),
    "maxpool_tau": ("cofii2p_tpu_torch/csrc/maxpool.cu", "cofii2p_tpu/ops/maxpool_kernel.py:657"),
    "kpconv_transpose_dyn": ("cofii2p_tpu_torch/csrc/kpconv_transpose.cu", "cofii2p_tpu/ops/kpconv_kernel.py:442"),
    "kpconv_transpose_tau": ("cofii2p_tpu_torch/csrc/kpconv_transpose_mma.cuh",
                             "cofii2p_tpu/ops/kpconv_kernel.py:826"),
    "maxpool_bwd_dyn": ("cofii2p_tpu_torch/csrc/maxpool_bwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:452"),
    "maxpool_bwd_tau": ("cofii2p_tpu_torch/csrc/maxpool_bwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:783"),
    "residual_fused": ("cofii2p_tpu_torch/csrc/residual_fused.cu", "cofii2p_tpu/ops/residual_kernel.py:386"),
}
# the path whose launch counts the summary reports for each kernel
SERVE_KERNELS = ("kpconv_fused", "maxpool", "attention")
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
    from cofii2p_tpu_torch.ops import residual_kernel as rk
    from cofii2p_tpu_torch.ops import tau_kernel as tk

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
            "residual_fused": rk.banded_residual_fused}


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
        ref, ref_cnt = banded_kpconv_fused_plain(f, q, s, w, r, sg, 15, 128, bw, torch.float32, starts)
        out, cnt = banded_kpconv_fused(f, q, s, w, r, sg, 15, 128, bw, torch.float32, starts)
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
        p_ms = time_ms(lambda: banded_kpconv_fused_plain(*args16), 3)
        n = s.shape[1]
        bd = call_bound("banded_kpconv_fused", args16)
        # the timed kernel (bf16, tensor cores) against the plain version on its inputs
        tally.add("kpconv_fused", (out16 - ref16).abs().max().item(), k_ms, p_ms, bd)
        e16_same = rel_err(out16, ref16)
        del ref16
        say("kernels", f"kpconv_fused {name} B={b} N={n}: fp32 rel {e32:.2e}, bf16 rel {e16:.2e} "
            f"(vs the bf16 plain version {e16_same:.2e}), counts equal; bf16 kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")

    # --- B: maxpool ------------------------------------------------------
    for c, ql, sl in ((256, 2, 1), (1024, 4, 3)):
        q, s = levels[ql], levels[sl]
        r, sg = r0 * 2 ** (sl), s0 * 2 ** (sl)
        ra = kernel_reach(r, sg)
        st = dynamic_band_starts(q, s, ra, 128, 192, "best", max(1, s.shape[1] // 2560))
        for mode, bw, starts in (("static", plan[sl], None), ("w192", 192, st)):
            for dtype in (torch.float32, torch.bfloat16):
                f = torch.randn(b, s.shape[1], c, generator=gen).to(device, dtype)
                ref = banded_maxpool_plain(f, q, s, ra, 128, bw, starts)
                out = banded_maxpool_fused(f, q, s, ra, 128, bw, starts)
                torch.cuda.synchronize()
                bad = (out != ref).sum().item()
                if bad or out.dtype != dtype:
                    raise PhaseError(f"maxpool C={c} {mode} {dtype}: {bad} mismatches")
            k_ms = time_ms(lambda: banded_maxpool_fused(f, q, s, ra, 128, bw, starts))
            p_ms = time_ms(lambda: banded_maxpool_plain(f, q, s, ra, 128, bw, starts), 3)
            m, n = q.shape[1], s.shape[1]
            bd = call_bound("banded_maxpool_fused", (f, q, s, ra, 128, bw, starts))
            tally.add("maxpool", 0.0, k_ms, p_ms, bd)
            say("kernels", f"maxpool C={c} {mode} B={b} M={m} N={n}: 0 mismatches fp32+bf16; "
                f"bf16 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")

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


def check_training_kernels(device, gen, tally, cfg):
    """The four kernels of the training backward path against their plain
    versions, fp32, B=8, at the trainer's shapes; the aggregate (#2) also on
    encoder4_2's 2176-row band, where the CUDA-core template it replaced
    redid its membership for every kernel point."""
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
        torch.cuda.synchronize()
        e9 = rel_err(out, ref)
        if e9 > 1e-4:
            raise PhaseError(f"kpconv_transpose {name}: rel err {e9:.3e} > 1e-4")
        k_ms = time_ms(lambda: banded_kpconv_transpose_fused(g, q, s, r, sg, 15, 128, bw))
        p_ms = time_ms(lambda: banded_kpconv_transpose_plain(g, q, s, r, sg, 15, 128, bw), 3)
        bd = call_bound("banded_kpconv_transpose_fused", (g, q, s, r, sg, 15, 128, bw))
        tally.add("kpconv_transpose", (out - ref).abs().max().item(), k_ms, p_ms, bd)
        say("kernels", f"kpconv_transpose {name} B={b} M={m} N={n}: rel {e9:.2e}; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del g, out, ref

    # --- #12 tie count and #13 maxpool backward, with tied maxima -------------
    for c, ql, sl in ((128, 1, 0), (1024, 4, 3)):
        q, s = levels[ql], levels[sl]
        m, n = q.shape[1], s.shape[1]
        r, sg, bw = r0 * 2 ** sl, s0 * 2 ** sl, plan[sl]
        ra = kernel_reach(r, sg)
        base = torch.randn(b, sizes[0], c, generator=gen).to(device)
        f = torch.gather(base, 1, idents[sl][..., None].expand(-1, -1, c))  # duplicated points tie
        out = banded_maxpool_fused(f, q, s, ra, 128, bw)
        ref = banded_maxpool_tie_count_plain(f, q, s, out, ra, 128, bw)
        cnt = banded_maxpool_tie_count_fused(f, q, s, out, ra, 128, bw)
        torch.cuda.synchronize()
        if not torch.equal(cnt, ref):
            raise PhaseError(f"maxpool_count C={c}: {(cnt != ref).sum().item()} counts differ")
        ties = int((cnt > 1).sum())
        if ties == 0:
            raise PhaseError(f"maxpool_count C={c}: no tied maximum in a cloud with duplicated points")
        k_ms = time_ms(lambda: banded_maxpool_tie_count_fused(f, q, s, out, ra, 128, bw))
        p_ms = time_ms(lambda: banded_maxpool_tie_count_plain(f, q, s, out, ra, 128, bw), 3)
        bd = call_bound("banded_maxpool_tie_count_fused", (f, q, s, out, ra, 128, bw))
        tally.add("maxpool_count", 0.0, k_ms, p_ms, bd)
        say("kernels", f"maxpool_count C={c} B={b} M={m} N={n}: counts equal, {ties} tied (query, channel) "
            f"maxima; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        gs = torch.randn(b, m, c, generator=gen).to(device) / torch.clamp(cnt, min=1.0)
        ref = banded_maxpool_route_plain(gs, f, q, s, out, ra, 128, bw)
        got = banded_maxpool_backward_fused(gs, f, q, s, out, ra, 128, bw)
        torch.cuda.synchronize()
        e13 = rel_err(got, ref)
        if e13 > 1e-5:
            raise PhaseError(f"maxpool_bwd C={c}: rel err {e13:.3e} > 1e-5")
        k_ms = time_ms(lambda: banded_maxpool_backward_fused(gs, f, q, s, out, ra, 128, bw))
        p_ms = time_ms(lambda: banded_maxpool_route_plain(gs, f, q, s, out, ra, 128, bw), 3)
        bd = call_bound("banded_maxpool_backward_fused", (gs, f, q, s, out, ra, 128, bw))
        tally.add("maxpool_bwd", (got - ref).abs().max().item(), k_ms, p_ms, bd)
        say("kernels", f"maxpool_bwd C={c} B={b} M={m} N={n}: rel {e13:.2e}; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del base, f, out, ref, cnt, gs, got


def check_knn_kernels(device, gen, tally, cfg):
    """The four kernels of the `.t7` path against their plain versions at
    its fp32 shapes, B=8, on clouds with duplicated points: tau on every
    (query level, support level) pair of the FPN, bit-equal (its
    library_ms is torch.topk over the same (tile, band) d2 blocks); the tau
    KPConvs with per-layer kernel points and features of both signs, equal
    active-row counts, fp32 rel <= 1e-4 and bf16 rel <= 5e-2 (kernel #1's),
    at every width of the FPN (#6 at Cin 512, where the FPN takes it, and
    at lvl0's Cin 32, banded_knn training's largest write) and on bands of
    over 2048 rows (encoder4_2's 2176, encoder5_1's 2304); the tau maxpool
    bit-equal in fp32 and bf16."""
    import torch

    from cofii2p_tpu_torch.ops.banded import _load_kernel_points, _membership_d2, _tiles, band_plan
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
    for c, ql, sl in ((256, 2, 1), (1024, 4, 3)):
        q, s, bw, tau = levels[ql], levels[sl], plan[sl], taus[(ql, sl)]
        base = torch.randn(b, levels[0].shape[1], c, generator=gen).to(device)
        f = torch.gather(base, 1, idents[sl][..., None].expand(-1, -1, c))
        for dtype in (torch.float32, torch.bfloat16):
            fd = f.to(dtype)
            out = banded_maxpool_tau(fd, q, s, tau, 128, bw)
            ref = banded_maxpool_tau_plain(fd, q, s, tau, 128, bw)
            torch.cuda.synchronize()
            bad = (out != ref).sum().item()
            if bad or out.dtype != dtype:
                raise PhaseError(f"maxpool_tau C={c} {dtype}: {bad} mismatches")
        k_ms = time_ms(lambda: banded_maxpool_tau(f, q, s, tau, 128, bw))
        p_ms = time_ms(lambda: banded_maxpool_tau_plain(f, q, s, tau, 128, bw), 3)
        bd = call_bound("banded_maxpool_tau", (f, q, s, tau, 128, bw))
        tally.add("maxpool_tau", 0.0, k_ms, p_ms, bd)
        say("kernels", f"maxpool_tau C={c} lvl{ql}<-lvl{sl} B={b} M={q.shape[1]} N={s.shape[1]}: 0 mismatches "
            f"fp32+bf16; fp32 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
        del base, f, out, ref


def check_window_and_tau_backward_kernels(device, gen, tally, cfg):
    """The backward kernels of `train --fast` and of `banded_knn` training
    against their plain versions, fp32, B=8, on clouds with duplicated
    points: #10 (window transpose) and #14 (window maxpool backward) on the
    w256 windows the trainer places, with #12 on the same windows; #11
    (tau transpose) and #15 (tau maxpool backward) on the k-NN pairs'
    static bands (up to 2304 rows), with #12 by tau and per-layer kernel
    points.  Tie counts bit-equal, #10/#11 rel <= 1e-4, #14/#15 rel <=
    1e-5, #10's and #14's scatter bit-equal to its plain version on the
    kernel's own stack, and #11 the same bits on two launches."""
    import torch

    from cofii2p_tpu_torch.ops.banded import _load_kernel_points, dynamic_band_starts, kernel_reach
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

    def tied(c, sl):
        base = torch.randn(b, levels[0].shape[1], c, generator=gen).to(device)
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

    # --- #12 on windows and #14: the shortcuts of encoder3_1 and 5_1 ----------
    for c, ql, sl in ((256, 2, 1), (1024, 4, 3)):
        q, s = levels[ql], levels[sl]
        r, sg = r0 * 2 ** sl, s0 * 2 ** sl
        ra = kernel_reach(r, sg)
        st = window_starts(q, s, r, sg)
        f = tied(c, sl)
        out = banded_maxpool_fused(f, q, s, ra, 128, w, st)
        cargs = (f, q, s, out, ra, 128, w, st)
        ref = banded_maxpool_tie_count_plain(*cargs)
        cnt = banded_maxpool_tie_count_fused(*cargs)
        torch.cuda.synchronize()
        ties = int((cnt > 1).sum())
        if not torch.equal(cnt, ref) or ties == 0:
            raise PhaseError(f"maxpool_count w{w} C={c}: {(cnt != ref).sum().item()} counts differ, {ties} ties")
        timed("maxpool_count", banded_maxpool_tie_count_fused, banded_maxpool_tie_count_plain, cargs, 0.0,
              f"maxpool_count on windows C={c} w{w} B={b} M={q.shape[1]}: counts equal, {ties} tied maxima")
        gs = torch.randn(b, q.shape[1], c, generator=gen).to(device) / torch.clamp(cnt, min=1.0)
        args = (gs, f, q, s, out, st, ra, 128, w)
        ref = banded_maxpool_route_dyn_plain(*args)
        got = banded_maxpool_backward_dyn_fused(*args)
        got2, stack = route_dyn_with_stack(*args)
        scat = band_scatter_plain(stack, st, s.shape[1])
        torch.cuda.synchronize()
        e14 = rel_err(got, ref)
        if e14 > 1e-5 or not torch.equal(got2, scat) or not torch.equal(got, got2):
            raise PhaseError(f"maxpool_bwd_dyn C={c}: rel err {e14:.3e} (<= 1e-5), scatter bit-equal "
                             f"{torch.equal(got2, scat)}, repeatable {torch.equal(got, got2)}")
        mb = stack.numel() * 4 / 2**20
        timed("maxpool_bwd_dyn", banded_maxpool_backward_dyn_fused, banded_maxpool_route_dyn_plain, args,
              (got - ref).abs().max().item(),
              f"maxpool_bwd_dyn C={c} w{w} B={b} M={q.shape[1]} N={s.shape[1]}: rel {e14:.2e}, scatter bit-equal "
              f"on the kernel's {mb:.1f} MiB stack")
        del f, out, ref, cnt, gs, got, got2, stack, scat

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

    # --- #12 by tau and #15: the tau shortcuts of encoder3_1 and 5_1 ----------
    for c, ql, sl in ((256, 2, 1), (1024, 4, 3)):
        q, s, bw = levels[ql], levels[sl], plan[sl]
        tau = banded_knn_tau_plain(q, s, k, 128, bw)
        f = tied(c, sl)
        out = banded_maxpool_tau(f, q, s, tau, 128, bw)
        cargs = (f, q, s, out, 0.0, 128, bw, None, tau)
        ref = banded_maxpool_tie_count_plain(*cargs)
        cnt = banded_maxpool_tie_count_fused(*cargs)
        torch.cuda.synchronize()
        ties = int((cnt > 1).sum())
        if not torch.equal(cnt, ref) or ties == 0:
            raise PhaseError(f"maxpool_count tau C={c}: {(cnt != ref).sum().item()} counts differ, {ties} ties")
        timed("maxpool_count", banded_maxpool_tie_count_fused, banded_maxpool_tie_count_plain, cargs, 0.0,
              f"maxpool_count by tau C={c} B={b} M={q.shape[1]}: counts equal, {ties} tied maxima")
        gs = torch.randn(b, q.shape[1], c, generator=gen).to(device) / torch.clamp(cnt, min=1.0)
        args = (gs, f, q, s, out, tau, 128, bw)
        ref = banded_maxpool_route_tau_plain(*args)
        got = banded_maxpool_backward_tau_fused(*args)
        torch.cuda.synchronize()
        e15 = rel_err(got, ref)
        if e15 > 1e-5:
            raise PhaseError(f"maxpool_bwd_tau C={c}: rel err {e15:.3e} > 1e-5")
        timed("maxpool_bwd_tau", banded_maxpool_backward_tau_fused, banded_maxpool_route_tau_plain, args,
              (got - ref).abs().max().item(),
              f"maxpool_bwd_tau C={c} lvl{ql}<-lvl{sl} B={b} M={q.shape[1]} N={s.shape[1]}: rel {e15:.2e}")
        del f, out, ref, cnt, gs, got


def check_residual_kernel(device, gen, tally, cfg):
    """Kernel #16 against its plain version and against the pair it fuses
    (#1 then #3, kernel_bench.unfused_pair) on the same inputs, B=8, on
    clouds with duplicated points so that maxima tie: the four strided
    blocks at the serving shapes (bf16; w192 windows on support levels 1-3,
    the static band on level 0) and the three the fp32 static plan fuses.
    Counts equal and shortcuts bit-equal to both; the conv bit-equal to
    #1's, since it is #1's code at #1's block size (csrc/kpconv_fused.cuh),
    and within #1's thresholds of the plain version (fp32 rel <= 1e-3,
    bf16 rel <= 5e-2)."""
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
    make_step = train_lib.make_train_step

    def recording_make_train_step(cfg, model, optimizer, has_normals=True):
        captured["model"], captured["cfg"] = model, cfg
        captured["before"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_step(cfg, model, optimizer, has_normals)

        def timed_step(host_batch, draws):
            torch.cuda.synchronize()
            before = read_launches()
            t0 = time.perf_counter()
            metrics = step(host_batch, draws)
            torch.cuda.synchronize()
            per_step = {k: v - before[k] for k, v in read_launches().items()}
            steps.append((time.perf_counter() - t0, per_step, {k: float(v) for k, v in metrics.items()}))
            return metrics

        return timed_step

    root = tempfile.mkdtemp(prefix=f"{phase}_", dir=OUT_DIR)
    argv = ["kitti", f"root_path={root}", f"val_freq={TRAIN_STEPS}", "--synthetic", "--steps", str(TRAIN_STEPS),
            "--batch_size", str(BATCH), "--synthetic_frames", str(frames_total), *extra]
    train_lib.make_train_step = recording_make_train_step
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        save_dir = train_cli.main(argv)
    finally:
        train_lib.make_train_step = make_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # every step and the validation at the last one
    peak = torch.cuda.max_memory_allocated() / 2**30

    cfg = train_config(bench_path).replace(root_path=root, val_freq=TRAIN_STEPS)
    if captured["cfg"] != cfg:
        raise PhaseError(f"{phase}: train.main ran {captured['cfg']}, expected {cfg}")
    if len(steps) != TRAIN_STEPS:
        raise PhaseError(f"{phase}: {len(steps)} steps ran, expected {TRAIN_STEPS}")
    for i, (_, per_step, metrics) in enumerate(steps):
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
    shutil.rmtree(root, ignore_errors=True)
    del model, restored, captured
    torch.cuda.empty_cache()

    ms = [dt * 1e3 for dt, _, _ in steps]
    steady = sum(ms[1:]) / max(len(ms) - 1, 1)
    say(phase, f"{TRAIN_STEPS} steps x {BATCH} frames ({cfg.img_H}x{cfg.img_W}, {cfg.num_pc} pts), {what}, "
        "through train.main "
        f"in {wall:.1f} s: losses " + " -> ".join(f"{m['loss']:.4f}" for _, _, m in steps)
        + f", grad norm {steps[-1][2]['grad_norm']:.3f}; ms/step " + ", ".join(f"{x:.1f}" for x in ms)
        + f" (steady {steady:.1f} ms, {BATCH * 1e3 / steady:.2f} frames/s); peak {peak:.2f} GiB; "
        + "launches/step " + ", ".join(f"{k} {v}" for k, v in steps[-1][1].items() if v)
        + f"; {moved} parameter tensors moved; restored {os.path.basename(path)}, eval_step "
        + ", ".join(f"{k} {v:.3f}" for k, v in recalls.items()) + f"; card {smi_line}")
    if phase != "train":
        try:
            say(phase, "B=1 step, " + replay_step_layers(cfg, device, seed, windows_only=phase == "train_fast"))
        except PhaseError as e:
            raise PhaseError(f"{phase}: {e}") from None
    return launches


def check_pose(device, gen):
    """EPnP-RANSAC of the pipeline on scenes of known pose: serving size,
    0.5 px noise, 30% outlier pixels, half the rows masked out."""
    import math

    import torch

    from cofii2p_tpu_torch.pose.ransac import gumbel_noise, ransac_pnp

    b, n, hyp = BATCH, 1280, 512
    K = torch.tensor([[362.0, 0, 128], [0, 362.0, 40], [0, 0, 1]])
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
    args = [x.to(device) for x in (gumbel_noise((b, hyp, n), gen, "cpu"), world, uv, K.expand(b, 3, 3), mask)]
    res = ransac_pnp(*args, inlier_threshold=8.0)
    torch.cuda.synchronize()
    r_err = (res.R.cpu() - R).abs().max().item()
    t_err = (res.t.cpu() - t).norm(dim=-1).max().item()
    if not (res.success.all() and r_err <= 1e-2 and t_err <= 0.1):
        raise PhaseError(f"pose: success {res.success.tolist()}, max |R - R_gt| {r_err:.2e}, |t - t_gt| {t_err:.3f} m")
    say("pose", f"{b} frames x {n} correspondences, {hyp} hypotheses: all succeed, max |R - R_gt| {r_err:.1e}, "
        f"max |t - t_gt| {t_err:.4f} m, inliers {res.num_inliers.tolist()}")


def serve(device, seed, smi_line, profile=False, residual_fused=False, n_requests=REQUESTS):
    import torch

    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize
    from cofii2p_tpu_torch.utils.kernel_bench import serve_config

    phase = "serve_resfuse" if residual_fused else "serve"
    per_forward = PER_RESFUSE_FORWARD if residual_fused else PER_FORWARD
    cfg = serve_config(residual_fused)
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(device).eval()
    run = make_eval_body(cfg, model)
    requests = [frames(cfg, BATCH, device, start=i * BATCH) for i in range(n_requests + 1)]
    gen = torch.Generator(device).manual_seed(seed)
    run(requests[0], gen)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [run(hb, gen) for hb in requests[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(requests[1], gen)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
        with open(os.path.join(OUT_DIR, f"{phase}_profile.txt"), "w") as fh:
            fh.write(table)
        prof.export_chrome_trace(os.path.join(OUT_DIR, f"{phase}_trace.json"))
        say(phase, f"profile of one request written to chiprun_out/{phase}_profile.txt")
    for name, want in per_forward.items():
        n = launches[name]
        if want and n == 0:
            raise PhaseError(f"{phase}: kernel {name} was never launched on the main path")
        if n != want * n_requests:
            raise PhaseError(
                f"{phase}: {name} launched {n} times in {n_requests} forwards, expected {want} each "
                + ("(10 KPConvs, 4 strided blocks' conv and shortcut in one pass, 8 layers x 2 attention calls)"
                   if residual_fused else "(14 KPConvs, 4 strided shortcuts, 8 layers x 2 attention calls)")
            )
    eye = torch.eye(3, device=device)
    nonfinite_pose = 0
    for i, out in enumerate(outs):
        for field, val in out._asdict().items():
            if field not in ("R", "t") and val.is_floating_point() and not torch.isfinite(val).all():
                raise PhaseError(f"{phase}: request {i} field {field} has non-finite values")
        finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
        if not finite[out.success].all():
            raise PhaseError(f"{phase}: request {i} has a non-finite pose where RANSAC succeeded")
        nonfinite_pose += int((~finite).sum())
        orth = (out.R[finite].transpose(-1, -2) @ out.R[finite] - eye).abs().amax().item() if finite.any() else 0.0
        if orth > 1e-3:
            raise PhaseError(f"{phase}: request {i} |R^T R - I| = {orth:.2e} > 1e-3")
        if out.R.shape != (BATCH, 3, 3) or out.fine_xy.shape != (BATCH, cfg.num_superpoints, 2):
            raise PhaseError(f"{phase}: request {i} shapes {out.R.shape}, {out.fine_xy.shape}")
    fps = n_requests * BATCH / dt
    succ = sum(int(o.success.sum()) for o in outs)
    say(phase, f"{n_requests} requests x {BATCH} frames (160x512, 20480 pts), bf16 w192"
        + (", kpconv_residual_fused" if residual_fused else "") + f": {fps:.2f} frames/s, "
        f"{dt / n_requests * 1e3:.1f} ms/request, peak {peak:.2f} GiB, launches/forward "
        + ", ".join(f"{k} {launches[k] // n_requests}" for k in per_forward)
        + f"; RANSAC success {succ}/{n_requests * BATCH}, non-finite poses {nonfinite_pose} (all without success); "
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
    return launches, fps, peak


def serve_outputs(model, batch, cfg):
    """What tools/window_drift.py compares, from one test-mode forward:
    each superpoint's best image token, the selection mask, the fine pixel
    and the coarse score."""
    import torch

    from cofii2p_tpu_torch.models.network import fine_match_xy

    out = model(batch, mode="test")
    b, s, _ = out["pc_feature_norm"].shape
    sim = torch.einsum("bsc,blc->bsl", out["pc_feature_norm"].float(),
                       out["img_feature_norm"].reshape(b, -1, cfg.d_model).float())
    fine_xy = fine_match_xy(out["fine_img_patch"], out["fine_pc_feature"], out["fine_center_xy"], cfg.fine_decode)
    return dict(argmax=sim.argmax(-1), mask=out["inlier_mask"], fine_xy=fine_xy,
                score=out["coarse_pc_score"].float())


def check_serve_drift(cfg, model, hb, device, seed):
    """tools/window_drift.py's four readings between one bf16 B=8 serving
    forward through the kernels and the same weights, frames and draws
    through the plain versions on the card (kpconv_kernel='xla' and the
    attention wrapper's plain version, which keeps the kernel's bf16
    output; 'full' would return fp32): coarse-argmax drift, selection
    drift, fine-cell drift among the selected superpoints and max score
    drift.  Each must stay within twice the parent kernels' reading plus
    one point (SERVE_DRIFT_LIMITS)."""
    import torch

    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models import transformer as tf
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.ops.attention_kernel import fused_attention_plain

    draws = make_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    plain = CoFiI2P(cfg.replace(kpconv_kernel="xla")).to(device).eval()
    plain.load_state_dict(model.state_dict())
    kernel_attention = tf.fused_attention
    with torch.no_grad():
        reset_launches()
        got = serve_outputs(model, batch, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        tf.fused_attention = fused_attention_plain
        try:
            ref = serve_outputs(plain, batch, cfg)
            torch.cuda.synchronize()
        finally:
            tf.fused_attention = kernel_attention
        plain_launches = read_launches()
    del plain
    if plain_launches != launches or launches["kpconv_fused"] != PER_FORWARD["kpconv_fused"]:
        raise PhaseError(f"drift: launches {launches} through the kernels, {plain_launches} after the plain forward")
    either = ref["mask"] | got["mask"]
    n_sel = max(int(either.sum()), 1)
    moved = (ref["fine_xy"] - got["fine_xy"]).abs().amax(-1) > 1e-6
    drift = dict(argmax=float((ref["argmax"] != got["argmax"]).float().mean()),
                 selection=float((ref["mask"] != got["mask"]).float().mean()),
                 fine_cell=float((moved & either).sum()) / n_sel,
                 score=float((ref["score"] - got["score"]).abs().max()))
    over = {k: v for k, v in drift.items() if v > SERVE_DRIFT_LIMITS[k]}
    line = (f"drift of a B={BATCH} forward, kernels vs plain versions (same weights, frames, draws; {n_sel} "
            f"superpoints selected by either): coarse-argmax {drift['argmax']:.4f}, selection "
            f"{drift['selection']:.4f}, fine-cell (selected) {drift['fine_cell']:.4f}, max score {drift['score']:.5f}; "
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
    import glob
    import shutil
    import tempfile

    import numpy as np
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
        make_body = eval_all.make_eval_body

        def recording_make_eval_body(cfg_, model, has_normals=True):
            run = make_body(cfg_, model, has_normals)

            def timed(hb, generator=None, draws=None):
                torch.cuda.synchronize()
                before = read_launches()
                t0 = time.perf_counter()
                out = run(hb, generator, draws)
                torch.cuda.synchronize()
                per = {k: v - before[k] for k, v in read_launches().items()}
                batches.append((time.perf_counter() - t0, per, out, hb["pc"].shape[0]))
                return out

            return timed

        argv = [ckpt, "kitti", "--synthetic", "--synthetic_frames", str(frames_total), "--batch_size", str(BATCH),
                "--eval_path", root]
        cwd = os.getcwd()
        eval_all.make_eval_body = recording_make_eval_body
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            os.chdir(root)  # the error arrays go to the working directory
            r_errs, _ = eval_all.main(argv)
        finally:
            eval_all.make_eval_body = make_body
            os.chdir(cwd)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30

        dumps = sorted(glob.glob(os.path.join(root, "kitti", "*", "*.npy")))
        if len(dumps) != frames_total:
            raise PhaseError(f"t7: {len(dumps)} per-frame dumps, expected {frames_total}")
        for path in dumps:
            keys = set(np.load(path, allow_pickle=True).item())
            if keys != T7_DUMP_KEYS:
                raise PhaseError(f"t7: {os.path.basename(path)} holds {sorted(keys)}, expected {sorted(T7_DUMP_KEYS)}")
        for arr in ("kitti_t_error.npy", "kitti_r_error.npy"):
            if not os.path.exists(os.path.join(root, arr)):
                raise PhaseError(f"t7: {arr} was not written")
        if len(batches) != frames_total // BATCH:
            raise PhaseError(f"t7: {len(batches)} batches ran, expected {frames_total // BATCH}")
        for i, (_, per, out, _) in enumerate(batches):
            for name, want in PER_T7_FORWARD.items():
                if per[name] != want:
                    raise PhaseError(f"t7: batch {i} launched {name} {per[name]} times, expected {want}")
            finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
            if not finite[out.success].all():
                raise PhaseError(f"t7: batch {i} has a non-finite pose where RANSAC succeeded")
        fps = batches[1][3] / batches[1][0]
        succ = sum(int(o.success.sum()) for _, _, o, _ in batches)
        say("t7", "eval_all.main on ref.t7 (seeded weights, per-layer kernel points), "
            f"{frames_total} frames x B={BATCH}, fp32 {cfg.kpconv_impl}, attention {cfg.attention}: {len(dumps)} "
            "dumps with the reference's keys and both error arrays; second batch "
            f"{batches[1][0] * 1e3:.1f} ms ({fps:.2f} frames/s), first {batches[0][0] * 1e3:.1f} ms; "
            f"peak {peak:.2f} GiB; launches/forward "
            + ", ".join(f"{k} {batches[1][1][k]}" for k in PER_T7_FORWARD)
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
            run("pose", check_pose, device, gen)
        if "serve" in phases:
            served, _, _ = run("serve", serve, device, args.seed, smi_line, args.profile, False, args.requests)
            launches.update({k: served[k] for k in SERVE_KERNELS})
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
