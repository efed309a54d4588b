"""The forward band max's block plan (csrc/maxpool_plan.cuh, kernels #3 and
#8) on the CPU, so that a launch the card would refuse (too much shared
memory, too many registers, a segment walk that misses band rows) shows
here and not on the card.

The plan is plain constexpr C++, the one the kernel is built with: the host
compiler evaluates it here for the two builds (fp32 and bf16, a lane
taking 16 bytes of channels in each) and for the segment and slice counts
the launcher takes.  Every strided shortcut of every
path that runs the kernel is checked at its real shape: serving (bf16,
w192 windows on the deep levels), the static trainer and its fp32 eval,
`--fast` (w256 windows), the `.t7` eval and `banded_knn` training (k-NN
membership on static bands): C = 128 to 1024 in both dtypes, its band in
whole segments of kept membership bits, and a band longer than one
segment.  The launchers take no TQ: the plan sizes the block.
"""

import inspect
import os
import re
import shutil
import subprocess

import pytest

from cofii2p_tpu_torch.config import SERVE_DYNAMIC_PLAN, SERVE_DYNAMIC_PLAN_SELF, KITTIConfig, with_fast_windows
from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
from cofii2p_tpu_torch.models.kpconv import KPConvFPN
from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import band_plan
from cofii2p_tpu_torch.ops.maxpool_kernel import banded_maxpool_fused, banded_maxpool_tau
from cofii2p_tpu_torch.utils import maxpool_knockout

# the H100's budgets, stated here apart from the header's own static_asserts
SMEM_PER_BLOCK, SMEM_PER_SM, REGS_PER_SM = 232448, 233472, 65536
FIELDS = ("esz", "vec", "threads", "tq", "qpw", "cs", "row_bytes", "seg", "words", "rb", "smem", "min_blocks",
          "acc_regs", "walk")
BUILDS = ((4, 4), (2, 8))  # (bytes of a feature, channels a lane) of each kernel built
BANDS = (128, 192, 256, 384, 512, 768, 1536, 2304, 2560, 3072, 3073, 3456, 6144, 7000)

PLAN_DUMP = r"""
#include <cstdio>
#include "maxpool_plan.cuh"

template <int ESZ>
void row() {
  using P = cofii2p::PoolPlan<ESZ>;
  std::printf("plan %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n", ESZ, P::VEC, P::THREADS, P::TQ, P::QPW, P::CS,
              P::ROW_BYTES, P::SEG, P::WORDS, P::RB, P::SMEM, P::MIN_BLOCKS, P::ACC_REGS, cofii2p::kPoolWalk);
}

int main() {
  row<4>();
  row<2>();
  const int bands[] = {BANDS};
  for (int band : bands) std::printf("seg %d %d\n", band, cofii2p::pool_segments(band));
  for (int c = 1; c <= 1100; ++c)
    std::printf("slices %d %d %d\n", c, cofii2p::pool_slices(c, cofii2p::PoolPlan<4>::CS),
                cofii2p::pool_slices(c, cofii2p::PoolPlan<2>::CS));
  return 0;
}
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """What the host compiler makes of csrc/maxpool_plan.cuh: the plan of
    each build, pool_segments over BANDS, pool_slices over C = 1..1100
    (fp32 and bf16)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler evaluates the plan header"
    d = tmp_path_factory.mktemp("maxpool_plan")
    src, exe = d / "plan.cc", d / "plan"
    src.write_text(PLAN_DUMP.replace("{BANDS}", "{" + ", ".join(map(str, BANDS)) + "}"))
    res = subprocess.run([cxx, "-std=c++17", "-I", cuda_lib.CSRC, "-o", str(exe), str(src)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr  # a static_assert of the plan fails here
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    got = {"plan": {}, "seg": {}, "slices": {}}
    for line in out.splitlines():
        kind, *vals = line.split()
        vals = [int(v) for v in vals]
        if kind == "plan":
            got["plan"][tuple(vals[:2])] = dict(zip(FIELDS, vals))
        elif kind == "seg":
            got["seg"][vals[0]] = vals[1]
        else:
            got["slices"][vals[0]] = tuple(vals[1:])
    return got


def test_every_build_has_a_plan(built):
    assert sorted(built["plan"]) == sorted(BUILDS)


@pytest.mark.parametrize("esz,vec", BUILDS, ids=[f"{'fp32' if e == 4 else 'bf16'}-vec{v}" for e, v in BUILDS])
def test_block_plan_fits_the_card(built, esz, vec):
    """Shared memory within the block's and (MIN_BLOCKS blocks) the SM's,
    the running maxima within half a thread's registers, the warps cover
    the 128-query tile, a lane loads 16 bytes of a staged row, and a
    staged chunk is one membership word a query."""
    p = built["plan"][(esz, vec)]
    assert p["smem"] <= SMEM_PER_BLOCK
    assert p["min_blocks"] * (p["smem"] + 1024) <= SMEM_PER_SM  # 1 KB of each block's is the system's
    assert p["acc_regs"] <= REGS_PER_SM // (p["threads"] * p["min_blocks"]) // 2
    assert p["acc_regs"] == p["qpw"] * vec * esz // 4
    assert p["tq"] == 128 and p["qpw"] * p["threads"] // 32 == p["tq"]
    assert p["vec"] == vec and vec * esz == 16 and p["cs"] == 32 * vec and p["row_bytes"] == p["cs"] * esz
    assert p["rb"] == 32 and p["words"] * 32 == p["seg"] and p["seg"] % p["threads"] == 0
    assert p["seg"] <= 1 << 16  # 16-bit listed rows
    assert 1 <= p["walk"] <= 8


@pytest.mark.parametrize("band", BANDS)
def test_segments_tile_the_band(built, band):
    """pool_segments(band) segments of SEG rows cover the band, each
    segment non-empty: the kernel walks [s SEG, min(band, (s + 1) SEG))."""
    seg = built["plan"][(4, 4)]["seg"]
    n = built["seg"][band]
    covered = [r for s in range(n) for r in range(s * seg, min(band, (s + 1) * seg))]
    assert covered == list(range(band))
    assert all(s * seg < band for s in range(n))
    assert n == 1 or band > seg


@pytest.mark.parametrize("esz,vec", BUILDS, ids=["fp32", "bf16"])
def test_lanes_and_slices_cover_every_channel(built, esz, vec):
    """fp32 lanes take 4 channels, bf16 lanes 8; the pool_slices(C, CS)
    slices of 32 lanes cover every C from 1 to 1100, the last slice not
    empty."""
    cs = built["plan"][(esz, vec)]["cs"]
    assert cs == 32 * vec
    for c, n in built["slices"].items():
        n = n[0 if esz == 4 else 1]
        assert (n - 1) * cs < c <= n * cs


def strided_shortcuts(cfg, **fpn_kw):
    """(name, query level, support level, C, band, windowed) of the four
    strided shortcuts of a KITTI forward under ``cfg``."""
    fpn = KPConvFPN(input_dim=cfg.kpconv_input_dim, init_dim=cfg.kpconv_init_dim, band_plan=cfg.kpconv_band_plan,
                    dynamic_plan=fpn_kw.get("dynamic_plan", cfg.kpconv_dynamic_plan),
                    dynamic_plan_self=fpn_kw.get("dynamic_plan_self", cfg.kpconv_dynamic_plan_self),
                    impl=cfg.kpconv_impl, knn_window_plan=cfg.kpconv_knn_window_plan)
    sizes, calls = cfg.pyramid_sizes, []
    for stage in range(2, 6):
        name = f"encoder{stage}_1"
        block, ql = getattr(fpn, name), stage - 1
        assert block.strided
        windowed = bool(fpn.dyn_w(ql - 1, False) or fpn.knn_w(ql - 1))
        _, _, band = band_plan(sizes[ql], sizes[ql - 1], 128, block.band_width, True if windowed else None)
        cin = block.KPConv.weights.shape[1] if block.unary1 is None else block.unary1.mlp.in_features
        calls.append((name, ql, ql - 1, cin, band, windowed))
    return calls


PATHS = {
    "serve": (KITTIConfig(), dict(dynamic_plan=SERVE_DYNAMIC_PLAN, dynamic_plan_self=SERVE_DYNAMIC_PLAN_SELF), 2),
    "train_and_fp32_eval": (KITTIConfig(), {}, 4),
    "fast": (with_fast_windows(KITTIConfig()), {}, 4),
    "t7": (reference_ckpt_config(KITTIConfig(), {}, device="cpu"), {}, 4),
    "knn_train": (KITTIConfig(kpconv_impl="banded_knn"), {}, 4),
}
EXPECTED = {  # (band or window width of encoder2_1 .. encoder5_1, windowed)
    "serve": [(512, False), (192, True), (192, True), (192, True)],
    "train_and_fp32_eval": [(512, False), (768, False), (1536, False), (2304, False)],
    "fast": [(512, False), (256, True), (256, True), (256, True)],
    "t7": [(512, False), (768, False), (1536, False), (2304, False)],
    "knn_train": [(512, False), (768, False), (1536, False), (2304, False)],
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_strided_shortcut_fits_the_plan(built, path):
    """Each path's four strided shortcuts (encoder2_1 .. encoder5_1, C =
    128, 256, 512, 1024) in the dtype the path runs them (serving bf16,
    the others fp32; both are built): a tile of 128 queries, the band in
    one segment of kept membership bits, the slices covering C, and the
    block's shared memory within the card's."""
    cfg, kw, esz = PATHS[path]
    calls = strided_shortcuts(cfg, **kw)
    assert [(c[4], c[5]) for c in calls] == EXPECTED[path]
    assert [c[3] for c in calls] == [128, 256, 512, 1024]
    for name, ql, sl, c, band, _ in calls:
        for e in (esz, 6 - esz):  # the path's dtype, then the other
            p = built["plan"][(e, 16 // e)]
            assert built["seg"].get(band, 1 if band <= p["seg"] else None) == 1, (name, band)
            slices = built["slices"][c][0 if e == 4 else 1]
            assert slices * p["cs"] >= c > (slices - 1) * p["cs"], name
            assert p["smem"] <= SMEM_PER_BLOCK
        tile = band_plan(cfg.pyramid_sizes[ql], cfg.pyramid_sizes[sl], 128, 1024)[0]
        assert tile == 128, name


def test_a_band_over_one_segment_takes_two(built):
    """256 + 2 * 1600 = 3456 rows (the card's test of a long band) walks
    two segments; the largest band of the FPN's shortcuts, 2304, one."""
    assert built["seg"][3456] == 2 and built["seg"][2304] == 1 and built["seg"][3072] == 1
    assert built["seg"][3073] == 2


def _c_params(launcher):
    """The parameter list of an ``extern "C"`` launcher of csrc/."""
    for f in sorted(os.listdir(cuda_lib.CSRC)):
        if f.endswith(".cu"):
            m = re.search(r'extern "C" int ' + launcher + r"\(([^)]*)\)", open(os.path.join(cuda_lib.CSRC, f)).read())
            if m:
                return m.group(1)
    raise AssertionError(f"no launcher {launcher}")


def test_forward_launchers_take_no_tq():
    """maxpool_launch (#3) and maxpool_tau_launch (#8) take their block
    from the plan: neither the C signature, nor its ctypes declaration, nor
    the wrapper passes a TQ; the tie count's launchers (#12) keep theirs."""
    for launcher, wrapper in (("maxpool_launch", banded_maxpool_fused), ("maxpool_tau_launch", banded_maxpool_tau)):
        assert "TQ" not in _c_params(launcher)
        assert "pick_tq" not in inspect.getsource(wrapper)
    assert len(cuda_lib.SIGNATURES["maxpool_launch"]) == 14
    assert len(cuda_lib.SIGNATURES["maxpool_tau_launch"]) == 14
    for launcher in ("maxpool_count_launch", "maxpool_count_tau_launch"):
        assert "int TQ" in _c_params(launcher)


def test_plan_header_stands_alone():
    """The plan header includes nothing, so a host compiler reads it."""
    with open(os.path.join(cuda_lib.CSRC, "maxpool_plan.cuh")) as fh:
        assert "#include" not in fh.read()



@pytest.mark.parametrize("part", maxpool_knockout.PARTS)
def test_knockouts_apply_to_the_forward_source(part):
    """The knock-out tool's edits of the forward kernel each find their text
    once in csrc/maxpool_fwd.cu, and a plan variant sets the header's
    constants, so the by-part timing of PERF.md can be run again."""
    with open(os.path.join(cuda_lib.CSRC, "maxpool_fwd.cu")) as fh:
        assert maxpool_knockout.patch(fh.read(), maxpool_knockout.KNOCKOUTS["maxpool_fwd.cu"][part])
    with open(os.path.join(cuda_lib.CSRC, "maxpool_plan.cuh")) as fh:
        header = fh.read()
    got = maxpool_knockout.patch(header, maxpool_knockout.plan_edits(header, "kPoolThreads=256,kPoolWalk=2"))
    assert "constexpr int kPoolThreads = 256;" in got and "constexpr int kPoolWalk = 2;" in got
