#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases device,build,kernels

Phases (each prints one or more lines; any failure exits non-zero before
the last line):
  device   require CUDA; print the nvidia-smi name and power limit; TF32 off
  build    compile cofii2p_tpu_torch/csrc/*.cu with nvcc, one process per
           source (first use, cached by source hash under
           build/cofii2p_tpu_torch/)
  kernels  each CUDA kernel against its plain PyTorch version: the serving
           kernels at the serving shapes, fp32 and bf16; the training
           kernels (aggregate, transposed aggregate, tie count, maxpool
           backward) at the trainer's fp32 shapes, B=8, on clouds with
           duplicated points so that maxima tie; the kernel's and the plain
           version's time (CUDA events) and the least time the card could
           take for the same work (the larger of bytes over 3.35 TB/s and
           operations over the peak rate of their type)
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
           attention) with seeded random weights: a warm-up, then 3
           requests of 8 KITTI-shaped synthetic frames through
           make_eval_body; launch counts per forward, finite network
           outputs, finite proper rotations wherever RANSAC succeeded,
           frames/s and peak memory.  Random weights give few and junk
           correspondences, on which the JAX package's ransac_pnp itself
           returns NaN poses for some frames; those are counted, not
           failed.
  train    `python -m cofii2p_tpu_torch.train kitti --synthetic --steps 4
           --batch_size 8` through train.main (fp32, static bands, full
           KITTI width, val at step 4): launches per step of each kernel,
           finite losses and gradient norm, parameters moved, the
           checkpoint restores and one eval_step runs on it; ms/step,
           frames/s and peak memory.
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
PHASES = ("device", "build", "kernels", "fp32", "grad", "pose", "serve", "train")
BATCH = 8
REQUESTS = 3
TRAIN_STEPS = 4
PER_FORWARD = {"kpconv_fused": 14, "maxpool": 4, "attention": 16}
# launches per train step: 14 KPConvs forward, 13 feature gradients (not
# encoder1_1's, whose input needs none), 4 strided shortcuts forward and
# backward; no fused KPConv and no fused attention while differentiating
PER_STEP = {"kpconv_aggregate": 14, "kpconv_transpose": 13, "maxpool": 4, "maxpool_count": 4, "maxpool_bwd": 4,
            "kpconv_fused": 0, "attention": 0}
KERNELS = {
    "kpconv_fused": ("cofii2p_tpu_torch/csrc/kpconv_fused.cu", "cofii2p_tpu/ops/kpconv_kernel.py:1007"),
    "maxpool": ("cofii2p_tpu_torch/csrc/maxpool.cu", "cofii2p_tpu/ops/maxpool_kernel.py:208"),
    "attention": ("cofii2p_tpu_torch/csrc/attention.cu", "cofii2p_tpu/ops/attention_kernel.py:53"),
    "kpconv_aggregate": ("cofii2p_tpu_torch/csrc/kpconv_fused.cu", "cofii2p_tpu/ops/kpconv_kernel.py:228"),
    "kpconv_transpose": ("cofii2p_tpu_torch/csrc/kpconv_transpose.cu", "cofii2p_tpu/ops/kpconv_kernel.py:516"),
    "maxpool_count": ("cofii2p_tpu_torch/csrc/maxpool.cu", "cofii2p_tpu/ops/maxpool_kernel.py:315"),
    "maxpool_bwd": ("cofii2p_tpu_torch/csrc/maxpool_bwd.cu", "cofii2p_tpu/ops/maxpool_kernel.py:537"),
}
# the path whose launch counts the summary reports for each kernel
SERVE_KERNELS = ("kpconv_fused", "maxpool", "attention")


def wrappers():
    """Every kernel wrapper by its summary name (each counts its launches)."""
    from cofii2p_tpu_torch.ops import attention_kernel as att
    from cofii2p_tpu_torch.ops import kpconv_kernel as kpk
    from cofii2p_tpu_torch.ops import maxpool_kernel as mpk

    return {"kpconv_fused": kpk.banded_kpconv_fused, "maxpool": mpk.banded_maxpool_fused,
            "attention": att.fused_attention, "kpconv_aggregate": kpk.banded_kpconv_aggregate_fused,
            "kpconv_transpose": kpk.banded_kpconv_transpose_fused,
            "maxpool_count": mpk.banded_maxpool_tie_count_fused, "maxpool_bwd": mpk.banded_maxpool_backward_fused}


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
    from cofii2p_tpu_torch.ops.attention_kernel import fused_attention, fused_attention_plain
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
    a_cases = []
    q2 = levels[2]
    r2_, s2_ = r0 * 4, s0 * 4
    st = dynamic_band_starts(q2, q2, kernel_reach(r2_, s2_), 128, 192, "best", max(1, q2.shape[1] // 2560))
    a_cases.append(("lvl2 static C128", q2, q2, 128, 128, r2_, s2_, plan[2], None))
    a_cases.append(("lvl2 w192 C128", q2, q2, 128, 128, r2_, s2_, 192, st))
    q4 = levels[4]
    a_cases.append(("lvl4 static C512", q4, q4, 512, 512, r0 * 16, s0 * 16, plan[4], None))
    for name, q, s, cin, cout, r, sg, bw, starts in a_cases:
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
        fb = f.to(torch.bfloat16)
        out16, cnt16 = banded_kpconv_fused(fb, q, s, w, r, sg, 15, 128, bw, torch.bfloat16, starts)
        torch.cuda.synchronize()
        e16 = rel_err(out16, ref)
        if e16 > 5e-2:
            raise PhaseError(f"kpconv {name}: bf16 rel err {e16:.3e} > 5e-2 vs fp32 plain")
        args16 = (fb, q, s, w, r, sg, 15, 128, bw, torch.bfloat16, starts)
        k_ms = time_ms(lambda: banded_kpconv_fused(*args16))
        p_ms = time_ms(lambda: banded_kpconv_fused_plain(*args16), 3)
        n = s.shape[1]
        bd = call_bound("banded_kpconv_fused", args16)
        tally.add("kpconv_fused", (out - ref).abs().max().item(), k_ms, p_ms, bd)
        say("kernels", f"kpconv_fused {name} B={b} N={n}: fp32 rel {e32:.2e}, bf16 rel {e16:.2e}, "
            f"counts equal; bf16 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")

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
    q, k, v = (torch.randn(b, 1280, 4, 32, generator=gen).to(device) for _ in range(3))
    q = q / q.norm(dim=1, keepdim=True)
    ref = fused_attention_plain(q, k, v)
    e32 = (fused_attention(q, k, v) - ref).abs().max().item()
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out16 = fused_attention(qb, kb, vb)
    torch.cuda.synchronize()
    e16 = (out16.float() - ref).abs().max().item()
    if e32 > 1e-5 or e16 > 2e-2 or out16.dtype != torch.bfloat16:
        raise PhaseError(f"attention: fp32 abs {e32:.2e} (<=1e-5), bf16 abs {e16:.2e} (<=2e-2), dtype {out16.dtype}")
    c_ms = time_ms(lambda: fused_attention(qb, kb, vb))
    c_plain = time_ms(lambda: fused_attention_plain(qb, kb, vb))
    # the library's fused attention on the same inputs, timed as a yardstick only
    qh, kh, vh = (x.transpose(1, 2) for x in (qb, kb, vb))
    c_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
    bd = call_bound("fused_attention", (qb, kb, vb))
    tally.add("attention", e32, c_ms, c_plain, bd, library_ms=c_lib)
    say("kernels", f"attention (8,1280,4,32): fp32 abs {e32:.2e}, bf16 abs {e16:.2e}, out bf16; "
        f"bf16 kernel {c_ms:.3f} ms, plain {c_plain:.3f} ms, scaled_dot_product_attention {c_lib:.3f} ms, "
        f"bound {bd[0]:.3f} ms ({bd[1]})")

    check_training_kernels(device, gen, tally, cfg)


def check_training_kernels(device, gen, tally, cfg):
    """The four kernels of the training backward path against their plain
    versions, fp32, B=8, at the trainer's shapes."""
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
             ("lvl4 C512 full band", 4, 4, 512, r0 * 16, s0 * 16, plan[4])]
    for name, ql, sl, c, r, sg, bw in cases:
        q, s = levels[ql], levels[sl]
        m, n = q.shape[1], s.shape[1]
        f = torch.randn(b, n, c, generator=gen).to(device)
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
        g = torch.randn(b, m, 15, c, generator=gen).to(device)
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


def frames(cfg, count, device, start=0):
    import torch

    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cfg, "val", length=start + count)
    hb = _collate([ds[start + i] for i in range(count)])
    hb.pop("index")
    return {k: torch.as_tensor(v).to(device) for k, v in hb.items()}


def check_fp32_path(device, seed):
    """The whole forward at B=1, fp32: kernels vs plain versions."""
    import torch

    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize

    cfg = KITTIConfig(kpconv_dynamic_plan=SERVE_DYNAMIC_PLAN, kpconv_dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF,
                      attention="pallas")
    plain_cfg = cfg.replace(kpconv_kernel="xla", attention="full")
    gen = torch.Generator().manual_seed(seed)
    model = randomize(CoFiI2P(cfg), gen).to(device).eval()
    plain = CoFiI2P(plain_cfg).to(device).eval()
    plain.load_state_dict(model.state_dict())
    hb = frames(cfg, 1, device)
    draws = make_draws(cfg, 1, torch.Generator(device).manual_seed(seed), device)
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    with torch.no_grad():
        got, ref = model(batch), plain(batch)
    torch.cuda.synchronize()
    errs = {f"fpn[{i}]": rel_err(g, r) for i, (g, r) in enumerate(zip(got["pc_features"], ref["pc_features"]))}
    errs["transformer_img"] = rel_err(got["img_mid"], ref["img_mid"])
    errs["transformer_pc"] = rel_err(got["pc_fused"], ref["pc_fused"])
    worst = max(errs.values())
    if worst > 1e-3:
        raise PhaseError(f"fp32 kernels vs plain: {errs}")
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
    local = check_layer_grads(calls, device)
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


def check_layer_grads(calls, device):
    """Each recorded KPConv and strided-maxpool call of the kernel step,
    replayed through its autograd Function and through autograd of its
    plain version on the same inputs with one random cotangent."""
    import torch

    from cofii2p_tpu_torch.models.kpconv import KPConv
    from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_apply, banded_kpconv_fused_plain
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_apply, banded_maxpool_plain

    gen = torch.Generator(device).manual_seed(0)
    worst_kp, worst_mp, n_kp, n_mp = 0.0, 0.0, 0, 0
    while calls:
        mod, (s_feats, q, s, *_) = calls.pop(0)
        grads, g = [], None
        if isinstance(mod, KPConv):
            for fn in (banded_kpconv_apply, banded_kpconv_fused_plain):
                f = s_feats.clone().requires_grad_()
                w = mod.weights.detach().clone().requires_grad_()
                out, _ = fn(f, q, s, w, mod.radius, mod.sigma, mod.kernel_size, mod.tile, mod.band_width, mod.dtype)
                g = torch.randn(out.shape, generator=gen, device=device) if g is None else g
                out.backward(g)
                grads.append((f.grad, w.grad))
                del out, f, w
            e = max(rel_err(grads[0][0], grads[1][0]), rel_err(grads[0][1], grads[1][1]))
            worst_kp, n_kp = max(worst_kp, e), n_kp + 1
            if e > 1e-4:
                raise PhaseError(f"grad: KPConv M={q.shape[1]} N={s.shape[1]} C={s_feats.shape[-1]}: "
                                 f"feature/weight gradient rel {e:.2e} > 1e-4 against the plain version")
        else:
            for fn in (banded_maxpool_apply, banded_maxpool_plain):
                f = s_feats.clone().requires_grad_()
                out = fn(f, q, s, mod.r_active, mod.tile, mod.band_width)
                g = torch.randn(out.shape, generator=gen, device=device) if g is None else g
                out.backward(g)
                grads.append(f.grad)
                del out, f
            e = rel_err(grads[0], grads[1])
            worst_mp, n_mp = max(worst_mp, e), n_mp + 1
            if e > 1e-5:
                raise PhaseError(f"grad: maxpool M={q.shape[1]} C={s_feats.shape[-1]}: gradient rel {e:.2e} > 1e-5")
        del grads, g, s_feats
        torch.cuda.empty_cache()
    if (n_kp, n_mp) != (14, 4):
        raise PhaseError(f"grad: replayed {n_kp} KPConv and {n_mp} maxpool calls, expected 14 and 4")
    return (f"layer by layer on the step's own inputs: {n_kp} KPConvs worst rel {worst_kp:.2e} (<= 1e-4), "
            f"{n_mp} maxpools worst rel {worst_mp:.2e} (<= 1e-5)")


def train(device, seed, smi_line):
    """The trainer's main path through its CLI entry point, then a restore
    of its checkpoint and one eval_step on it."""
    import shutil
    import tempfile

    import torch

    from cofii2p_tpu_torch import train as train_cli
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.config import KITTIConfig
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

    steps, frames_total = [], 40
    captured = {}
    make_step = train_lib.make_train_step

    def recording_make_train_step(cfg, model, optimizer, has_normals=True):
        captured["model"] = model
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

    root = tempfile.mkdtemp(prefix="train_", dir=OUT_DIR)
    argv = ["kitti", f"root_path={root}", f"val_freq={TRAIN_STEPS}", "--synthetic", "--steps", str(TRAIN_STEPS),
            "--batch_size", str(BATCH), "--synthetic_frames", str(frames_total)]
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

    if len(steps) != TRAIN_STEPS:
        raise PhaseError(f"train: {len(steps)} steps ran, expected {TRAIN_STEPS}")
    for i, (_, per_step, metrics) in enumerate(steps):
        for name, want in PER_STEP.items():
            if per_step[name] != want:
                raise PhaseError(f"train: step {i} launched {name} {per_step[name]} times, expected {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise PhaseError(f"train: step {i} metrics not finite: {metrics}")
    model = captured["model"]
    moved = sum(int(not torch.equal(p.detach(), captured["before"][n])) for n, p in model.named_parameters())
    if moved == 0:
        raise PhaseError("train: no parameter changed in 4 steps")
    path = latest_checkpoint(save_dir)
    if path is None:
        raise PhaseError(f"train: no checkpoint under {save_dir}")
    cfg = KITTIConfig()
    restored = CoFiI2P(cfg).to(device)
    step_no = restore_checkpoint(path, restored)
    mismatched = [k for k, v in model.state_dict().items() if not torch.equal(v, restored.state_dict()[k])]
    if step_no != TRAIN_STEPS or mismatched:
        raise PhaseError(f"train: checkpoint step {step_no}, {len(mismatched)} tensors differ after restore")
    hb = frames(cfg, BATCH, device, start=frames_total)
    recalls = train_lib.make_eval_step(cfg, restored)(
        hb, train_lib.make_train_draws(cfg, BATCH, torch.Generator(device).manual_seed(seed), device))
    recalls = {k: float(v) for k, v in recalls.items()}
    if not all(math.isfinite(v) for v in recalls.values()):
        raise PhaseError(f"train: eval_step on the restored checkpoint not finite: {recalls}")
    shutil.rmtree(root, ignore_errors=True)

    ms = [dt * 1e3 for dt, _, _ in steps]
    steady = sum(ms[1:]) / max(len(ms) - 1, 1)
    say("train", f"{TRAIN_STEPS} steps x {BATCH} frames ({cfg.img_H}x{cfg.img_W}, {cfg.num_pc} pts), fp32 static bands, "
        "through train.main "
        f"in {wall:.1f} s: losses " + " -> ".join(f"{m['loss']:.4f}" for _, _, m in steps)
        + f", grad norm {steps[-1][2]['grad_norm']:.3f}; ms/step " + ", ".join(f"{x:.1f}" for x in ms)
        + f" (steady {steady:.1f} ms, {BATCH * 1e3 / steady:.2f} frames/s); peak {peak:.2f} GiB; "
        + "launches/step " + ", ".join(f"{k} {v}" for k, v in steps[-1][1].items())
        + f"; {moved} parameter tensors moved; restored {os.path.basename(path)}, eval_step "
        + ", ".join(f"{k} {v:.3f}" for k, v in recalls.items()) + f"; card {smi_line}")
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


def serve(device, seed, smi_line, profile=False):
    import torch

    from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig
    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.ops.attention_kernel import fused_attention
    from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_fused
    from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_fused
    from cofii2p_tpu_torch.utils.convert import randomize

    # bench.py:277-282, the serving configuration
    cfg = KITTIConfig(compute_dtype="bfloat16", kpconv_dynamic_plan=SERVE_DYNAMIC_PLAN,
                      kpconv_dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF, attention="pallas")
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(seed)).to(device).eval()
    run = make_eval_body(cfg, model)
    requests = [frames(cfg, BATCH, device, start=i * BATCH) for i in range(REQUESTS + 1)]
    gen = torch.Generator(device).manual_seed(seed)
    run(requests[0], gen)  # warm-up
    torch.cuda.synchronize()
    wrappers = {"kpconv_fused": banded_kpconv_fused, "maxpool": banded_maxpool_fused, "attention": fused_attention}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [run(hb, gen) for hb in requests[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(requests[1], gen)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
        with open(os.path.join(OUT_DIR, "serve_profile.txt"), "w") as fh:
            fh.write(table)
        prof.export_chrome_trace(os.path.join(OUT_DIR, "serve_trace.json"))
        say("serve", "profile of one request written to chiprun_out/serve_profile.txt")
    for name, n in launches.items():
        if n == 0:
            raise PhaseError(f"serve: kernel {name} was never launched on the main path")
        if n != PER_FORWARD[name] * REQUESTS:
            raise PhaseError(
                f"serve: {name} launched {n} times in {REQUESTS} forwards, expected {PER_FORWARD[name]} each "
                "(14 KPConvs, 4 strided shortcuts, 8 layers x 2 attention calls)"
            )
    eye = torch.eye(3, device=device)
    nonfinite_pose = 0
    for i, out in enumerate(outs):
        for field, val in out._asdict().items():
            if field not in ("R", "t") and val.is_floating_point() and not torch.isfinite(val).all():
                raise PhaseError(f"serve: request {i} field {field} has non-finite values")
        finite = torch.isfinite(out.R).flatten(1).all(-1) & torch.isfinite(out.t).all(-1)
        if not finite[out.success].all():
            raise PhaseError(f"serve: request {i} has a non-finite pose where RANSAC succeeded")
        nonfinite_pose += int((~finite).sum())
        orth = (out.R[finite].transpose(-1, -2) @ out.R[finite] - eye).abs().amax().item() if finite.any() else 0.0
        if orth > 1e-3:
            raise PhaseError(f"serve: request {i} |R^T R - I| = {orth:.2e} > 1e-3")
        if out.R.shape != (BATCH, 3, 3) or out.fine_xy.shape != (BATCH, cfg.num_superpoints, 2):
            raise PhaseError(f"serve: request {i} shapes {out.R.shape}, {out.fine_xy.shape}")
    fps = REQUESTS * BATCH / dt
    succ = sum(int(o.success.sum()) for o in outs)
    say("serve", f"{REQUESTS} requests x {BATCH} frames (160x512, 20480 pts), bf16 w192: {fps:.2f} frames/s, "
        f"{dt / REQUESTS * 1e3:.1f} ms/request, peak {peak:.2f} GiB, launches/forward "
        + ", ".join(f"{k} {v // REQUESTS}" for k, v in launches.items())
        + f"; RANSAC success {succ}/{REQUESTS * BATCH}, non-finite poses {nonfinite_pose} (all without success); "
        f"card {smi_line}")
    return launches, fps, peak


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
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
    launches = {}
    try:
        if "kernels" in phases:
            check_kernels(device, gen, tally)
        if "fp32" in phases:
            check_fp32_path(device, args.seed)
        if "grad" in phases:
            check_grad(device, args.seed)
        if "pose" in phases:
            check_pose(device, gen)
        if "serve" in phases:
            served, _, _ = serve(device, args.seed, smi_line, args.profile)
            launches.update({k: served[k] for k in SERVE_KERNELS})
        if "train" in phases:
            trained = train(device, args.seed, smi_line)
            launches.update({k: v for k, v in trained.items() if k not in SERVE_KERNELS})
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
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
