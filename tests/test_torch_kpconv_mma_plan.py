"""The tensor-core KPConvs' block plans (csrc/kpconv_mma_plan.cuh) on the CPU,
so that a launch the card would refuse (too much shared memory, too many
registers, a block that does not tile the band) shows here and not on the
card.

The plan is plain constexpr C++, the one the kernel is built with: the host
compiler evaluates it here for every width pair the kernel is built for.
Each pair's block takes a number of queries that divides the 128-query band
tile, asks for at most 232,448 bytes of shared memory (and the blocks an SM
must hold fit its 228 KB together), holds at most half its share of
registers in fp32 accumulators, and its 8 warps tile the aggregate and the
output exactly.  The pairs built are every padded width the wrapper sends
to the kernel, so every KPConv of the KITTI FPN (serving's bf16 plan and
the fp32 static plan) has one; the weight layout the wrapper ships gives
each lane its B fragments.  The same for the k-NN (tau) kernel's plan
(``TauPlan``, kernels #7 and #6, fp32 by 3xTF32 and bf16): every width
pair in both precisions, the kept membership bits of the `.t7` FPN's
bands (one slice each), the fp32 weight layout.  The same kernel under
radius membership (kernel #2, CO = 0) is built for every padded Cin the
trainer's aggregate calls take, and its wrapper leaves the block size to
the plan.  The tensor-core transposed kernel's plan (``TransposePlan``,
kernel #11): every channel range in both precisions, 64 support rows a
block as the wrapper plans its windows, and every window of the k-NN
trainer's transposes within one segment of kept membership bits.
"""

import inspect
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig
from cofii2p_tpu_torch.models.kpconv import KPConvFPN
from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import _band_starts_np, band_plan, bwd_geometry
from cofii2p_tpu_torch.ops.kpconv_kernel import (
    MAX_CHANNELS,
    TRANSPOSE_TS,
    banded_kpconv_aggregate_fused,
    banded_kpconv_aggregate_tau,
    banded_kpconv_fused_tau,
    fused_contraction_fits,
    fused_launch_plan,
    mma_pad,
    mma_weights,
    pick_tq,
    tf32_weights,
)

# the H100's budgets, stated here apart from the header's own static_asserts
SMEM_PER_BLOCK, SMEM_PER_SM, REGS_PER_SM, THREADS = 232448, 233472, 65536, 256
WIDTHS = (32, 64, 128, 256, 512)
PAIRS = [(ci, co) for ci in WIDTHS for co in WIDTHS]
FIELDS = ("ci", "co", "tq", "rb", "smem", "min_blocks", "acc_regs", "wma", "wna", "ma", "na", "wmo", "wno", "mo", "no")
TILES = (1, 8, 16, 32, 64, 128)
TAU_FIELDS = ("ci", "co", "f32", "tq", "rb", "smem", "min_blocks", "acc_regs", "wma", "wna", "ma", "na", "wmo", "wno",
              "mo", "no", "mask_bytes")
# the tau kernel's plans, filled by the ``built`` fixture: (CI, CO, F32) ->
# plan, "band" -> (kTauSeg, kTauWords), ("widths", c) -> tau_widths
TAU_BUILT = {}
TAU_PAIRS = [(ci, co, f32) for ci in WIDTHS for co in (0, *WIDTHS) for f32 in (1, 0)]
TR_FIELDS = ("cb", "f32", "ts", "rb", "smem", "min_blocks", "acc_regs", "wma", "wna", "ma", "na")
# the transposed kernel's plans and the radius builds, filled by ``built``:
# (CB, F32) -> plan, "radius" -> [CI], "qseg" -> (kTransposeQSeg,
# kTransposeMaxCB), ("cb", c) -> transpose_cb(c)
TR_BUILT = {}
TR_CBS = [(cb, f32) for cb in (32, 64, 128, 256) for f32 in (1, 0)]

PLAN_DUMP = r"""
#include <cstdio>
#include "kpconv_mma_plan.cuh"

template <int CI, int CO>
void row() {
  using P = cofii2p::MmaPlan<CI, CO>;
  std::printf("plan %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n", CI, CO, P::TQ, P::RB, P::SMEM, P::MIN_BLOCKS,
              P::ACC_REGS, P::WMA, P::WNA, P::MA, P::NA, P::WMO, P::WNO, P::MO, P::NO);
}

template <int CI, int CO, bool F32>
void tau_row() {
  using P = cofii2p::TauPlan<CI, CO, F32>;
  std::printf("tau %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n", CI, CO, F32 ? 1 : 0, P::TQ, P::RB, P::SMEM,
              P::MIN_BLOCKS, P::ACC_REGS, P::WMA, P::WNA, P::MA, P::NA, P::WMO, P::WNO, P::MO, P::NO, P::MASK_BYTES);
}

template <int CB, bool F32>
void tr_row() {
  using P = cofii2p::TransposePlan<CB, F32>;
  std::printf("tr %d %d %d %d %d %d %d %d %d %d %d\n", CB, F32 ? 1 : 0, P::TS, P::RB, P::SMEM, P::MIN_BLOCKS,
              P::ACC_REGS, P::WMA, P::WNA, P::MA, P::NA);
}

int main() {
#define ROW(ci, co) row<ci, co>();
  COFII2P_MMA_WIDTHS(ROW)
#define TAU_ROW(ci, co) tau_row<ci, co, true>(); tau_row<ci, co, false>();
  COFII2P_TAU_WIDTHS(TAU_ROW)
#define TR_ROW(cb) tr_row<cb, true>(); tr_row<cb, false>();
  COFII2P_TRANSPOSE_WIDTHS(TR_ROW)
#define RADIUS_ROW(ci) std::printf("radius %d\n", ci);
  COFII2P_RADIUS_WIDTHS(RADIUS_ROW)
  std::printf("qseg %d %d\n", cofii2p::kTransposeQSeg, cofii2p::kTransposeMaxCB);
  for (int c = 1; c <= 512; ++c) std::printf("cb %d %d\n", c, cofii2p::transpose_cb(c));
  std::printf("band %d %d\n", cofii2p::kTauSeg, cofii2p::kTauWords);
  for (int c = 0; c <= 600; c += 8)
    std::printf("tauw %d %d\n", c, cofii2p::tau_widths(c ? c : 1, c) ? 1 : 0);
  for (int c = 1; c <= 600; ++c)
    std::printf("pad %d %d %d\n", c, cofii2p::mma_pad(c), cofii2p::mma_widths(c, 32) ? 1 : 0);
  const int tiles[] = {1, 8, 16, 32, 64, 128}, plan_tqs[] = {32, 64};
  for (int tile : tiles)
    for (int tq : plan_tqs) std::printf("tq %d %d %d\n", tile, tq, cofii2p::mma_tq(tile, tq));
  return 0;
}
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """What the host compiler makes of csrc/kpconv_mma_plan.cuh: the plan of
    each pair built, mma_pad and mma_widths over widths 1..600, mma_tq."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler evaluates the plan header"
    d = tmp_path_factory.mktemp("mma_plan")
    src, exe = d / "plan.cc", d / "plan"
    src.write_text(PLAN_DUMP)
    res = subprocess.run([cxx, "-std=c++17", "-I", cuda_lib.CSRC, "-o", str(exe), str(src)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr  # a static_assert of the plan fails here
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    plans, pads, tqs = {}, {}, {}
    for line in out.splitlines():
        kind, *vals = line.split()
        vals = [int(v) for v in vals]
        if kind == "plan":
            plans[tuple(vals[:2])] = dict(zip(FIELDS, vals))
        elif kind == "pad":
            pads[vals[0]] = (vals[1], bool(vals[2]))
        elif kind == "tq":
            tqs[tuple(vals[:2])] = vals[2]
        elif kind == "tau":
            TAU_BUILT[tuple(vals[:3])] = dict(zip(TAU_FIELDS, vals))
        elif kind == "band":
            TAU_BUILT["band"] = vals
        elif kind == "tr":
            TR_BUILT[tuple(vals[:2])] = dict(zip(TR_FIELDS, vals))
        elif kind == "radius":
            TR_BUILT.setdefault("radius", []).append(vals[0])
        elif kind == "qseg":
            TR_BUILT["qseg"] = vals
        elif kind == "cb":
            TR_BUILT[("cb", vals[0])] = vals[1]
        else:
            TAU_BUILT[("widths", vals[0])] = bool(vals[1])
    return plans, pads, tqs


def test_every_padded_width_pair_is_built(built):
    plans, _, _ = built
    assert sorted(plans) == sorted(PAIRS)


@pytest.mark.parametrize("ci,co", PAIRS, ids=[f"{ci}x{co}" for ci, co in PAIRS])
def test_block_plan_fits_the_card(built, ci, co):
    p = built[0][(ci, co)]
    assert 128 % p["tq"] == 0 and p["tq"] % 16 == 0
    assert p["smem"] <= SMEM_PER_BLOCK
    assert p["min_blocks"] * (p["smem"] + 1024) <= SMEM_PER_SM  # 1 KB of each block's is the system's
    assert p["acc_regs"] <= REGS_PER_SM // (THREADS * p["min_blocks"]) // 2  # half the registers for the rest
    assert p["rb"] % 16 == 0
    # the 8 warps tile the (TQ, CI) aggregate and the (TQ, CO) output
    # exactly, in 16 x 8 fragments
    for wm, wn, mt, nt, width in ((p["wma"], p["wna"], p["ma"], p["na"], ci), (p["wmo"], p["wno"], p["mo"], p["no"], co)):
        assert wm * wn == THREADS // 32
        assert wm * mt * 16 == p["tq"] and wn * nt * 8 == width


def test_pad_and_widths_agree_with_the_wrapper(built):
    """The header pads as mma_pad does and takes every width the wrapper
    sends it (bf16, <= MAX_CHANNELS); each padded width has its pairs."""
    plans, pads, _ = built
    for c, (pad, taken) in pads.items():
        assert pad == mma_pad(c)
        assert taken == (c <= MAX_CHANNELS)
        if taken:
            assert (pad, 32) in plans and (32, pad) in plans


@pytest.mark.parametrize("tile", TILES)
def test_queries_per_block_divide_the_tile(built, tile):
    """The launcher's mma_tq: the largest power of two within the plan that
    divides the band tile (128 in the FPN, less on a small level)."""
    tqs = built[2]
    for tq_max in (32, 64):
        tq = tqs[(tile, tq_max)]
        assert tile % tq == 0 and tq <= tq_max and (tq == tq_max or tile % (2 * tq) or 2 * tq > tq_max)


PLANS = {
    "serve": dict(dynamic_plan=SERVE_DYNAMIC_PLAN, dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF),
    "fp32_static": dict(),
}


def fpn_convs(plan):
    """(name, Cin, Cout) of the 14 KPConvs of the KITTI FPN under a band plan."""
    cfg = KITTIConfig()
    fpn = KPConvFPN(input_dim=cfg.kpconv_input_dim, init_dim=cfg.kpconv_init_dim, band_plan=cfg.kpconv_band_plan,
                    **PLANS[plan])
    return [(name, *mod.KPConv.weights.shape[1:]) for name, mod in fpn.named_children() if name.startswith("encoder")]


CASES = [(plan, *conv) for plan in PLANS for conv in fpn_convs(plan)]


def test_the_fpn_has_fourteen_convs():
    for plan in PLANS:
        convs = fpn_convs(plan)
        assert len(convs) == 14
        assert {(c[1], c[2]) for c in convs} == {(4, 64), (32, 32), (64, 64), (128, 128), (256, 256), (512, 512)}


@pytest.mark.parametrize("plan,name,cin,cout", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_fpn_convs_take_the_tensor_core_kernel_in_bf16(built, plan, name, cin, cout):
    """In bf16 each conv ships W in the tensor-core layout for a pair that
    is built; in fp32 it keeps the CUDA-core template's fp32 W and <= 32
    queries a block."""
    w = torch.randn(15, cin, cout)
    wk, tq = fused_launch_plan(cin, cout, 128, torch.bfloat16, w)
    ci, co = mma_pad(cin), mma_pad(cout)
    assert (ci, co) in built[0]
    assert wk.dtype == torch.bfloat16 and wk.shape == (15, co, ci) and tq == 0
    w32, tq32 = fused_launch_plan(cin, cout, 128, torch.float32, w)
    assert w32.dtype == torch.float32 and torch.equal(w32, w) and 128 % tq32 == 0 and tq32 <= 32


@pytest.mark.parametrize("cin,cout", [(4, 64), (8, 8), (64, 128), (600, 64)])
def test_bf16_widths_over_the_kernel_keep_the_cuda_core_template(cin, cout):
    """Widths up to MAX_CHANNELS take the tensor-core layout in bf16; wider
    ones (which the wrapper refuses) and every fp32 call the CUDA-core
    template's fp32 weights and <= 32 queries a block."""
    w = torch.randn(15, cin, cout)
    wk, tq = fused_launch_plan(cin, cout, 128, torch.bfloat16, w)
    if max(cin, cout) <= MAX_CHANNELS:
        assert wk.dtype == torch.bfloat16 and wk.shape == (15, mma_pad(cout), mma_pad(cin)) and tq == 0
    else:
        assert wk.dtype == torch.float32 and wk.shape == w.shape and 0 < tq <= 32
    w32, tq32 = fused_launch_plan(cin, cout, 128, torch.float32, w)
    assert w32.dtype == torch.float32 and torch.equal(w32, w) and 0 < tq32 <= 32


@pytest.mark.parametrize("cin,cout", [(4, 64), (512, 512)])
def test_weight_layout_gives_each_lane_its_b_fragments(cin, cout):
    """One 16-byte load at (k, n, 32 * s + 8 * t) of mma_weights' layout
    is lane group t's B fragments (b0, b1) of k-steps 2s and 2s + 1 for
    output column n: channels 16 ks + 2t, 2t + 1, 8 + 2t, 9 + 2t of each."""
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.standard_normal((15, cin, cout)).astype(np.float32))
    ci, co = mma_pad(cin), mma_pad(cout)
    wt = mma_weights(w, ci, co).float()
    ref = torch.zeros(15, ci, co)
    ref[:, :cin, :cout] = w.bfloat16().float()
    for s in range(ci // 32):
        for t in range(4):
            chans = [16 * ks + o + 2 * t + e for ks in (2 * s, 2 * s + 1) for o in (0, 8) for e in (0, 1)]
            got = wt[:, :, 32 * s + 8 * t: 32 * s + 8 * t + 8]
            assert torch.equal(got, ref[:, chans, :].transpose(1, 2))


def test_plan_header_stands_alone():
    """The plan header includes nothing, so a host compiler reads it."""
    with open(os.path.join(cuda_lib.CSRC, "kpconv_mma_plan.cuh")) as fh:
        assert "#include" not in fh.read()


def test_every_tau_width_is_built(built):
    """Kernels #7 (every padded (CI, CO) pair) and #6 (CO = 0, every padded
    CI) are built in fp32 (3xTF32) and in bf16; tau_widths takes 1..512."""
    assert sorted(k for k in TAU_BUILT if len(k) == 3) == sorted(TAU_PAIRS)
    for c in range(0, 601, 8):
        assert TAU_BUILT[("widths", c)] == (c <= MAX_CHANNELS)


@pytest.mark.parametrize("ci,co,f32", TAU_PAIRS, ids=[f"{'f32' if f else 'bf16'}-{ci}x{co}" for ci, co, f in TAU_PAIRS])
def test_tau_plan_fits_the_card(built, ci, co, f32):
    """The tau kernel's plan: TQ divides the band tile, shared memory within
    the block's and (MIN_BLOCKS blocks) the SM's, fp32 accumulators within
    half the registers, the 8 warps tile the aggregate (and the output)
    exactly; fp32 at 64 queries where no width is 512, as bf16."""
    p = TAU_BUILT[(ci, co, f32)]
    assert 128 % p["tq"] == 0 and p["tq"] % 16 == 0
    assert p["tq"] == (64 if max(ci, co) <= 256 else 32)
    assert p["smem"] <= SMEM_PER_BLOCK
    assert p["min_blocks"] * (p["smem"] + 1024) <= SMEM_PER_SM
    assert p["acc_regs"] <= REGS_PER_SM // (THREADS * p["min_blocks"]) // 2
    assert p["rb"] % 16 == 0
    tilings = [(p["wma"], p["wna"], p["ma"], p["na"], ci)]
    if co:
        tilings.append((p["wmo"], p["wno"], p["mo"], p["no"], co))
    for wm, wn, mt, nt, width in tilings:
        assert wm * wn == THREADS // 32
        assert wm * mt * 16 == p["tq"] and wn * nt * 8 == width


def test_tau_masks_cover_the_fpn_bands(built):
    """The kept membership bits cover a slice of kTauSeg rows, kTauWords
    words a query, and every static band of the KITTI FPN fits one slice,
    so there membership runs once a block: the `.t7` FPN's largest band,
    encoder5_1's 256 + 2 * 1024 = 2304 rows (lvl4 <- lvl3), takes 72 of
    its words."""
    seg, words = TAU_BUILT["band"]
    assert words * 32 == seg and seg % THREADS == 0  # a membership pass of 256 rows fills whole words
    assert seg <= 1 << 16  # the ordered rows of a slice are 16-bit
    cfg = KITTIConfig()
    sizes, plan = cfg.pyramid_sizes, cfg.kpconv_band_plan
    pairs = [(lvl, lvl) for lvl in range(5)] + [(lvl, lvl - 1) for lvl in range(1, 5)]
    bands = {(ql, sl): band_plan(sizes[ql], sizes[sl], 128, plan[sl])[2] for ql, sl in pairs}
    assert bands[(4, 3)] == 2304 and bands[(3, 3)] == 2176 and -(-bands[(4, 3)] // 32) == 72
    assert max(bands.values()) <= seg
    for ci, co, f32 in TAU_PAIRS:
        p = TAU_BUILT[(ci, co, f32)]
        assert p["mask_bytes"] == p["tq"] * words * 4


@pytest.mark.parametrize("wbytes", [4, 2])
def test_tau_builds_cover_the_fused_fit_rule(built, wbytes):
    """Every (Cin, Cout) that the model sends to the fused tau kernel
    (fused_contraction_fits, fp32 and bf16 weights) has its padded pair
    built in that precision."""
    f32 = int(wbytes == 4)
    for cin in range(1, MAX_CHANNELS + 1, 7):
        for cout in range(1, MAX_CHANNELS + 1, 7):
            if fused_contraction_fits(15, cin, cout, 128, wbytes):
                assert (mma_pad(cin), mma_pad(cout), f32) in TAU_BUILT


@pytest.mark.parametrize("cin,cout", [(4, 64), (256, 256)])
def test_tf32_weight_layout_gives_each_lane_its_b_fragments(cin, cout):
    """One 8-byte load at (k, n, 8 * ks + 2 * t) of tf32_weights' layout is
    lane group t's B fragment (b0, b1) of tf32 k-step ks for output column
    n: channels 8 ks + t and 8 ks + t + 4, in fp32."""
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.standard_normal((15, cin, cout)).astype(np.float32))
    ci, co = mma_pad(cin), mma_pad(cout)
    wt = tf32_weights(w, ci, co)
    assert wt.dtype == torch.float32 and wt.shape == (15, co, ci)
    ref = torch.zeros(15, ci, co)
    ref[:, :cin, :cout] = w
    for ks in range(ci // 8):
        for t in range(4):
            got = wt[:, :, 8 * ks + 2 * t: 8 * ks + 2 * t + 2]
            assert torch.equal(got, ref[:, [8 * ks + t, 8 * ks + t + 4], :].transpose(1, 2))


@pytest.mark.parametrize("fused", [True, False])
def test_tau_wrappers_take_bands_over_one_mask_slice(fused):
    """A band wider than one slice of kept membership bits (3200 rows: the
    kernel walks it in two slices) passes the wrappers' checks as the
    FPN's 2176-row band does, up to the launch (meta tensors: nothing
    runs)."""
    dev = torch.device("meta")
    m = n = 8192
    q = torch.empty(1, m, 3, device=dev)
    f = torch.empty(1, n, 32, device=dev)
    tau = torch.empty(1, m, device=dev)
    kp = torch.empty(15, 3, device=dev)
    w = torch.empty(15, 32, 32, device=dev)
    for width in (1536, 1024):  # bands of 3200 and 2176 rows
        assert band_plan(m, n, 128, width)[2] == 128 + 2 * width
        args = (f, q, q, w, tau, kp, 1.7, 0.8, 15, 128, width) if fused else (f, q, q, tau, kp, 1.7, 0.8, 15, 128, width)
        call = banded_kpconv_fused_tau if fused else banded_kpconv_aggregate_tau
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(*args)


def fpn_aggregate_widths():
    """Cin of every aggregate (#2) call the KITTI trainer makes: the 14
    differentiated convs of a train step, and the val forward's convs that
    the fused-fit rule sends to the aggregate in fp32."""
    convs = fpn_convs("fp32_static")
    train = {cin for _, cin, _ in convs}
    val = {cin for _, cin, cout in convs if not fused_contraction_fits(15, cin, cout, 128, 4)}
    return train, val


def test_radius_builds_cover_the_trainers_aggregate_calls(built):
    """Kernel #2 is the tau kernel's CO = 0 build under radius membership:
    every padded Cin of the FPN's aggregate calls (the train step's 14, the
    val forward's Cin = 512 pair) and every Cin the wrapper admits has its
    build, in fp32 (3xTF32) and in bf16."""
    radius = TR_BUILT["radius"]
    assert radius == list(WIDTHS)
    train, val = fpn_aggregate_widths()
    assert val == {512} and train == {4, 32, 64, 128, 256, 512}
    for cin in sorted(train | val | set(range(1, MAX_CHANNELS + 1))):
        assert mma_pad(cin) in radius
        for f32 in (1, 0):
            assert (mma_pad(cin), 0, f32) in TAU_BUILT  # the plan it launches with


def test_aggregate_wrapper_leaves_the_block_to_the_plan():
    """banded_kpconv_aggregate_fused computes no queries per block: the
    kernel takes its TauPlan's, so the launcher has no TQ parameter."""
    src = inspect.getsource(banded_kpconv_aggregate_fused)
    assert "pick_tq" not in src and "tq" not in src
    with open(os.path.join(cuda_lib.CSRC, "kpconv_aggregate.cu")) as fh:
        launcher = fh.read().split('extern "C" int kpconv_aggregate_launch(')[1].split(")")[0]
    assert "TQ" not in launcher
    assert len(cuda_lib.SIGNATURES["kpconv_aggregate_launch"]) == launcher.count(",") + 1


def test_every_transpose_width_is_built(built):
    """Kernel #11 is built for every channel range, 32..256, in fp32
    (3xTF32) and bf16, and every C the wrapper admits (1..512) maps to one
    (C = 512 takes two blocks of 256)."""
    assert sorted(k for k in TR_BUILT if len(k) == 2 and k[0] != "cb") == sorted(TR_CBS)
    _, max_cb = TR_BUILT["qseg"]
    for c in range(1, MAX_CHANNELS + 1):
        cb = TR_BUILT[("cb", c)]
        assert cb == min(mma_pad(c), max_cb) and (cb, 1) in TR_BUILT and (cb, 0) in TR_BUILT
        assert -(-c // cb) * cb >= c


@pytest.mark.parametrize("cb,f32", TR_CBS, ids=[f"{'f32' if f else 'bf16'}-{cb}" for cb, f in TR_CBS])
def test_transpose_plan_fits_the_card(built, cb, f32):
    """The transposed kernel's plan: 64 support rows a block (the wrapper's
    TRANSPOSE_TS, which the host plans the windows for), shared memory
    within the block's and (MIN_BLOCKS blocks) the SM's, fp32 accumulators
    within half the registers, the 8 warps tile the (TS, CB) sums exactly,
    a thread keeps one listed query of a chunk."""
    p = TR_BUILT[(cb, f32)]
    assert p["ts"] == TRANSPOSE_TS == 64
    assert p["smem"] <= SMEM_PER_BLOCK
    assert p["min_blocks"] * (p["smem"] + 1024) <= SMEM_PER_SM
    assert p["acc_regs"] <= REGS_PER_SM // (THREADS * p["min_blocks"]) // 2
    assert p["rb"] % 16 == 0 and THREADS % p["rb"] == 0
    assert p["wma"] * p["wna"] == THREADS // 32
    assert p["wma"] * p["ma"] * 16 == p["ts"] and p["wna"] * p["na"] * 8 == cb


def test_transpose_windows_fit_one_membership_segment(built):
    """Every transposed pass of the k-NN trainer (13 a step: each (query,
    support) level pair of the FPN but encoder1_1's) plans windows of query
    tiles that fit one segment of kept membership bits, so a block computes
    each pair's membership once; the 16-bit list holds a segment."""
    qseg, _ = TR_BUILT["qseg"]
    assert qseg <= 1 << 16
    cfg = KITTIConfig()
    sizes, plan = cfg.pyramid_sizes, cfg.kpconv_band_plan
    for ql, sl in [(lvl, lvl) for lvl in range(5)] + [(lvl, lvl - 1) for lvl in range(1, 5)]:
        m, n = sizes[ql], sizes[sl]
        tile, num_tiles, band = band_plan(m, n, 128, plan[sl])
        ts = pick_tq(n, TRANSPOSE_TS)
        assert ts == TRANSPOSE_TS
        _, _, q_win, _ = bwd_geometry(m, n, tile, band, _band_starts_np(m, n, tile, band, num_tiles), ts)
        assert q_win <= qseg, (ql, sl, q_win)
