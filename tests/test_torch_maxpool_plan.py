"""The banded maxpool's block plans (csrc/maxpool_plan.cuh) on the CPU: the
forward band max (kernels #3 and #8), its COUNT mode (the tie count, #12)
and the routing (#13, #14 and #15), so that a launch the card would refuse (too
much shared memory, too many registers, a segment walk that misses band
rows) shows here and not on the card.

The plan is plain constexpr C++, the one the kernel is built with: the host
compiler evaluates it here for the two builds (fp32 and bf16, a lane
taking 16 bytes of channels in each) and for the segment and slice counts
the launcher takes.  Every strided shortcut of every
path that runs the kernel is checked at its real shape: serving (bf16,
w192 windows on the deep levels), the static trainer and its fp32 eval,
`--fast` (w256 windows), the `.t7` eval and `banded_knn` training (k-NN
membership on static bands): C = 128 to 1024 in both dtypes, its band in
whole segments of kept membership bits, and a band longer than one
segment.  The launchers take no TQ: the plan sizes the block.  The
COUNT builds keep the forward's block within the same registers; the
routing's 64-row support tiles divide every static shortcut's support
level (radius and k-NN), each such shortcut's query window fits one
segment of membership words, and 64 divides every window width of
`--fast`.
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
from cofii2p_tpu_torch.ops.banded import _band_starts_np, band_plan, bwd_geometry
from cofii2p_tpu_torch.ops.kpconv_kernel import pick_tq
from cofii2p_tpu_torch.ops.maxpool_kernel import (
    ROUTE_TS,
    banded_maxpool_fused,
    banded_maxpool_tau,
    banded_maxpool_tie_count_fused,
)
from cofii2p_tpu_torch.utils import maxpool_knockout

# the H100's budgets, stated here apart from the header's own static_asserts
SMEM_PER_BLOCK, SMEM_PER_SM, REGS_PER_SM = 232448, 233472, 65536
FIELDS = ("esz", "vec", "threads", "tq", "qpw", "cs", "row_bytes", "seg", "words", "rb", "smem", "min_blocks",
          "acc_regs", "walk")
BUILDS = ((4, 4), (2, 8))  # (bytes of a feature, channels a lane) of each kernel built
COUNT_FIELDS = ("esz", "vec", "lane_bytes", "threads", "qpw", "cs", "row_bytes", "cnt_words", "smem", "acc_regs",
                "reg_budget")
ROUTE_FIELDS = ("esz", "threads", "warps", "ts", "rpw", "vec", "cs", "rb", "qseg", "qrow_bytes", "pieces", "smem",
                "min_blocks", "acc_regs", "reg_budget")
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

template <int ESZ>
void count_row() {
  using P = cofii2p::PoolPlan<ESZ, true>;
  std::printf("count %d %d %d %d %d %d %d %d %d %d %d\n", ESZ, P::VEC, P::LANE_BYTES, P::THREADS, P::QPW, P::CS,
              P::ROW_BYTES, P::CNT_WORDS, P::SMEM, P::ACC_REGS, P::REG_BUDGET);
}

template <int ESZ>
void route_row() {
  using P = cofii2p::RoutePlan<ESZ>;
  std::printf("route %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n", ESZ, P::THREADS, P::WARPS, P::TS, P::RPW, P::VEC,
              P::CS, P::RB, P::QSEG, P::QROW_BYTES, P::PIECES, P::SMEM, P::MIN_BLOCKS, P::ACC_REGS, P::REG_BUDGET);
}

int main() {
  row<4>();
  row<2>();
  count_row<4>();
  count_row<2>();
  route_row<4>();
  route_row<2>();
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
    got = {"plan": {}, "seg": {}, "slices": {}, "count": {}, "route": {}}
    for line in out.splitlines():
        kind, *vals = line.split()
        vals = [int(v) for v in vals]
        if kind == "plan":
            got["plan"][tuple(vals[:2])] = dict(zip(FIELDS, vals))
        elif kind == "count":
            got["count"][vals[0]] = dict(zip(COUNT_FIELDS, vals))
        elif kind == "route":
            got["route"][vals[0]] = dict(zip(ROUTE_FIELDS, vals))
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
    """maxpool_launch (#3), maxpool_tau_launch (#8) and the tie count's
    launchers (#12, the forward's kernel in COUNT mode) take their block
    from the plan: neither the C signature, nor its ctypes declaration, nor
    the wrapper passes a TQ."""
    for launcher, wrapper in (("maxpool_launch", banded_maxpool_fused), ("maxpool_tau_launch", banded_maxpool_tau),
                              ("maxpool_count_launch", banded_maxpool_tie_count_fused),
                              ("maxpool_count_tau_launch", banded_maxpool_tie_count_fused)):
        assert "TQ" not in _c_params(launcher)
        assert "pick_tq" not in inspect.getsource(wrapper)
    assert len(cuda_lib.SIGNATURES["maxpool_launch"]) == 14
    assert len(cuda_lib.SIGNATURES["maxpool_tau_launch"]) == 14
    assert len(cuda_lib.SIGNATURES["maxpool_count_launch"]) == 15
    assert len(cuda_lib.SIGNATURES["maxpool_count_tau_launch"]) == 15


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


@pytest.mark.parametrize("kernel,part", [(k, p) for k in ("count", "route", "radius")
                                         for p in maxpool_knockout.PARTS])
def test_knockouts_apply_to_the_count_and_route_sources(kernel, part):
    """The knock-out tool finds the tie count in csrc/maxpool_fwd.cu (its
    COUNT mode) and the k-NN and radius routings in csrc/maxpool_route.cu,
    and each of its edits finds its text once there."""
    src = maxpool_knockout.SOURCES[kernel][1]
    assert src == {"count": "maxpool_fwd.cu", "route": "maxpool_route.cu", "radius": "maxpool_route.cu"}[kernel]
    with open(os.path.join(cuda_lib.CSRC, src)) as fh:
        assert maxpool_knockout.patch(fh.read(), maxpool_knockout.KNOCKOUTS[src][part])


def _launcher_body(text, launcher):
    """The body of an ``extern "C"`` launcher in a source's text."""
    start = text.index(f'extern "C" int {launcher}(')
    return text[start:text.index("\n}\n", start)]


def test_count_kernel_file_is_gone_and_the_radius_backward_has_no_tau_mode():
    """#12 runs as the forward's COUNT mode, so csrc/maxpool.cu is gone;
    #13 and #14 run the routing kernel of csrc/maxpool_route.cu with its
    radius policy, which reads no tau (no TAU parameter or branch), and
    their launchers take no tau; #15's launcher is there with TauOnly."""
    assert not os.path.exists(os.path.join(cuda_lib.CSRC, "maxpool.cu"))
    with open(os.path.join(cuda_lib.CSRC, "maxpool_route.cu")) as fh:
        route = fh.read()
    policy = route[route.index("struct RadiusMember {"):route.index("};", route.index("struct RadiusMember {"))]
    assert "TAU" not in route and "tau" not in policy and "r2" in policy
    for launcher in ("maxpool_bwd_launch", "maxpool_bwd_dyn_launch"):
        body = _launcher_body(route, launcher)
        assert "tau" not in body and "RadiusMember{r2}" in body, launcher
    assert "TauOnly{" in _launcher_body(route, "maxpool_bwd_tau_launch")
    with open(os.path.join(cuda_lib.CSRC, "maxpool_fwd.cu")) as fh:
        fwd = fh.read()
    for launcher in ("maxpool_count_launch", "maxpool_count_tau_launch"):
        assert f'extern "C" int {launcher}(' in fwd


def test_the_routing_source_holds_the_three_routing_launchers():
    """csrc/maxpool_bwd.cu, the CUDA-core routing of #13 and #14, is gone:
    csrc/maxpool_route.cu holds exactly the three routing launchers (#13,
    #14 in window mode, #15), with the C signatures their ctypes
    declarations give."""
    assert not os.path.exists(os.path.join(cuda_lib.CSRC, "maxpool_bwd.cu"))
    with open(os.path.join(cuda_lib.CSRC, "maxpool_route.cu")) as fh:
        route = fh.read()
    launchers = ["maxpool_bwd_launch", "maxpool_bwd_dyn_launch", "maxpool_bwd_tau_launch"]
    assert re.findall(r'extern "C" int (\w+)\(', route) == launchers
    for launcher in launchers:
        assert _c_params(launcher).count(",") + 1 == len(cuda_lib.SIGNATURES[launcher]), launcher
    assert [len(cuda_lib.SIGNATURES[x]) for x in launchers] == [20, 18, 20]


@pytest.mark.parametrize("esz", [4, 2], ids=["fp32", "bf16"])
def test_count_plan_fits_the_card(built, esz):
    """COUNT keeps the forward's block (threads, queries a warp, segment,
    shared memory) and holds out and the counts of its queries in
    registers: a lane takes 4 channels (fp32 16 bytes, bf16 8), two 16-bit
    counts a word, so out and counts stay within half a thread's share of
    registers, as the forward's maxima do."""
    cp, fp = built["count"][esz], built["plan"][(esz, 16 // esz)]
    assert cp["vec"] == 4 and cp["lane_bytes"] == 4 * esz and cp["cs"] == 128
    assert cp["row_bytes"] == cp["cs"] * esz and cp["cnt_words"] == 2
    assert (cp["threads"], cp["qpw"], cp["smem"]) == (fp["threads"], fp["qpw"], fp["smem"])
    assert cp["acc_regs"] == cp["qpw"] * (cp["lane_bytes"] // 4 + cp["cnt_words"])
    assert cp["acc_regs"] <= cp["reg_budget"] == REGS_PER_SM // cp["threads"] // 2
    # a count is at most the band, at most N: the largest level's 20480 rows fit 16 bits
    assert max(KITTIConfig().pyramid_sizes) < 1 << 16


@pytest.mark.parametrize("c", [128, 256, 512, 1024, 20, 1100])
def test_count_slices_cover_every_channel(built, c):
    """The COUNT builds walk C in slices of 128 channels in both dtypes."""
    cs = built["count"][4]["cs"]
    assert built["count"][2]["cs"] == cs
    n = built["slices"][c][0]  # pool_slices(C, 128)
    assert (n - 1) * cs < c <= n * cs


@pytest.mark.parametrize("esz", [4, 2], ids=["fp32", "bf16"])
def test_route_plan_fits_the_card(built, esz):
    """The routing's block: 64 support rows (a bit each of a query's
    64-bit word; the wrapper's ROUTE_TS), the warps covering them, a lane
    4 channels (16 bytes of gs), chunks of 32 listed queries (one ballot
    word), shared memory within the block's and the SM's, and the rows'
    features and fp64 sums within half a thread's registers."""
    p = built["route"][esz]
    assert p["ts"] == ROUTE_TS == 64
    assert p["rpw"] * p["warps"] == p["ts"] and p["warps"] * 32 == p["threads"]
    assert p["vec"] == 4 and p["cs"] == 128 and p["rb"] == 32
    assert p["qrow_bytes"] == p["cs"] * (esz + 4) and p["pieces"] * 16 == p["qrow_bytes"]
    assert p["smem"] <= SMEM_PER_BLOCK and p["min_blocks"] * (p["smem"] + 1024) <= SMEM_PER_SM
    assert p["acc_regs"] == 3 * p["rpw"] * p["vec"] <= p["reg_budget"]  # fp32 features, fp64 sums
    assert p["reg_budget"] == REGS_PER_SM // (p["threads"] * p["min_blocks"]) // 2
    assert p["qseg"] % 128 == 0 and p["qseg"] <= 1 << 16


def _check_static_route_tiles(built, cfg, calls):
    """64-row support tiles divide each static shortcut's support level, and
    the window of query tiles a support tile walks (ops/banded.py::
    bwd_geometry, as the wrapper plans it) fits one segment of membership
    words."""
    qseg = built["route"][4]["qseg"]
    for name, ql, sl, c, band, windowed in calls:
        m, n = cfg.pyramid_sizes[ql], cfg.pyramid_sizes[sl]
        assert not windowed and n % ROUTE_TS == 0, name
        tile, num_tiles, band = band_plan(m, n, 128, band, None)
        stile, ns, q_win, qstart = bwd_geometry(m, n, tile, band, _band_starts_np(m, n, tile, band, num_tiles),
                                                ROUTE_TS)
        assert stile == ROUTE_TS and ns * stile == n and len(qstart) == ns, name
        assert q_win <= qseg, name
        assert (qstart >= 0).all() and (qstart + q_win // tile <= num_tiles).all(), name


def test_route_tiles_divide_every_knn_shortcut(built):
    """Each strided shortcut of `banded_knn` training (the only path that
    runs #15) at its real shape, as _check_static_route_tiles checks."""
    cfg = KITTIConfig(kpconv_impl="banded_knn")
    _check_static_route_tiles(built, cfg, strided_shortcuts(cfg))


@pytest.mark.parametrize("path", ["train_and_fp32_eval", "fast"])
def test_route_tiles_divide_every_radius_shortcut(built, path):
    """Each static strided shortcut of the paths that run #13 (the static
    trainer's four, `--fast`'s encoder2_1) at its real shape, as
    _check_static_route_tiles checks."""
    cfg, kw, _ = PATHS[path]
    calls = [c for c in strided_shortcuts(cfg, **kw) if not c[5]]
    assert len(calls) == {"train_and_fp32_eval": 4, "fast": 1}[path]
    _check_static_route_tiles(built, cfg, calls)


def test_route_tiles_divide_every_window_shortcut(built):
    """`--fast`'s three windowed shortcuts (encoder3_1 .. 5_1, the calls of
    #14): 64 divides the window width, so a window is whole blocks of
    ROUTE_TS rows (pick_tq(band, ROUTE_TS) == 64, as the wrapper passes),
    and a block's one query tile fits a segment of membership words."""
    cfg, kw, _ = PATHS["fast"]
    calls = [c for c in strided_shortcuts(cfg, **kw) if c[5]]
    assert [c[0] for c in calls] == ["encoder3_1", "encoder4_1", "encoder5_1"]
    for name, ql, sl, c, band, _ in calls:
        assert band % ROUTE_TS == 0 and pick_tq(band, ROUTE_TS) == ROUTE_TS, name
        assert band_plan(cfg.pyramid_sizes[ql], cfg.pyramid_sizes[sl], 128, band, True)[0] <= built["route"][4]["qseg"]
