"""Kernel #5's block plan (csrc/knn_tau_plan.cuh) on the CPU, so that a
launch the card would refuse (too much shared memory, too many registers)
or a digit schedule that misses a bit shows here and not on the card.

The plan is plain constexpr C++, the one the kernel is built with: the host
compiler evaluates it for every band of the seven paths (the 9 tau calls of
a `.t7` forward and of a `banded_knn` step, 384 to 2304 rows) and for
bands up to the wrapper's MAX_BAND.  The kernel's source is checked for
what the redesign removed (``__match_any_sync``, atomics, the count pass,
the wrapper's pick_tq), and the knock-out tool's edits for their text.
"""

import inspect
import os
import re
import shutil
import subprocess

import pytest

from cofii2p_tpu_torch.config import KITTIConfig
from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.banded import band_plan
from cofii2p_tpu_torch.ops.tau_kernel import MAX_BAND, banded_knn_tau_kernel
from cofii2p_tpu_torch.utils import maxpool_knockout

# the H100's budgets, stated here apart from the header's own static_asserts
SMEM_PER_BLOCK, SMEM_PER_SM, REGS_PER_SM = 232448, 233472, 65536
PATH_BANDS = (384, 512, 640, 768, 1280, 1408, 1536, 2176, 2304)
BANDS = (1, 31, 32, 33, 128, 256, *PATH_BANDS, 4096, 5073, 5074, 8192, 12000, MAX_BAND)
WIDTHS = (1, 2, 31, 32, 33, (1 << 21) - 1, 0x7F7FFFFF, 0x7F800000, 0x7FFFFFFF, 0xFFFFFFFF)
PLAN_FIELDS = ("band", "warps", "queries", "keep", "coord_bytes", "words", "smem", "min_blocks")

PLAN_DUMP = r"""
#include <cstdio>
#include "knn_tau_plan.cuh"

int main() {
  using namespace cofii2p;
  std::printf("const %d %d %d %d %d %d %d %d\n", kTauWarps, kTauQueries, kTauDigitBits, kTauFirstShift, kTauWalk,
              kTauListWords, kTauMaxBand, kTauRegs);
  const int bands[] = {BANDS};
  for (int band : bands) {
    const TauPlan p = tau_plan(band);
    std::printf("plan %d %d %d %d %d %d %d %d\n", band, p.warps, p.queries, p.keep ? 1 : 0, p.coord_bytes, p.words,
                p.smem, p.min_blocks);
  }
  const unsigned widths[] = {WIDTHS};
  for (unsigned w : widths) {
    std::printf("chain %u", w);
    for (unsigned x = w; x != 0u;) {
      const int s = tau_shift(x);
      std::printf(" %d:%d", tau_bit_length(x), s);
      x = s ? (1u << s) - 1u : 0u;  // the widest bin of the pass
    }
    std::printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """What the host compiler makes of csrc/knn_tau_plan.cuh: its
    constants, tau_plan over BANDS, and the chain of counting passes
    (bit length, shift) from each width of WIDTHS down to one pattern."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler evaluates the plan header"
    d = tmp_path_factory.mktemp("knn_tau_plan")
    src, exe = d / "plan.cc", d / "plan"
    src.write_text(PLAN_DUMP.replace("{BANDS}", "{" + ", ".join(map(str, BANDS)) + "}")
                   .replace("{WIDTHS}", "{" + ", ".join(f"{w}u" for w in WIDTHS) + "}"))
    res = subprocess.run([cxx, "-std=c++17", "-I", cuda_lib.CSRC, "-o", str(exe), str(src)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr  # a static_assert of the plan fails here
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    got = {"plan": {}, "chain": {}}
    for line in out.splitlines():
        kind, *vals = line.split()
        if kind == "const":
            got["const"] = dict(zip(("warps", "queries", "digit", "first", "walk", "list", "max_band", "regs"),
                                    map(int, vals)))
        elif kind == "plan":
            got["plan"][int(vals[0])] = dict(zip(PLAN_FIELDS, map(int, vals)))
        else:
            got["chain"][int(vals[0])] = [tuple(map(int, v.split(":"))) for v in vals[1:]]
    return got


def test_the_seven_paths_bands():
    """The tau calls of a `.t7` forward and a `banded_knn` step (one a pair
    of query level and support level) have the bands PATH_BANDS; the other
    five paths launch no tau."""
    for cfg in (reference_ckpt_config(KITTIConfig(), {}, device="cpu"), KITTIConfig(kpconv_impl="banded_knn")):
        sizes, plan = cfg.pyramid_sizes, cfg.kpconv_band_plan
        pairs = [(lvl, lvl) for lvl in range(5)] + [(lvl, lvl - 1) for lvl in range(1, 5)]
        got = sorted(band_plan(sizes[ql], sizes[sl], 128, plan[sl])[2] for ql, sl in pairs)
        assert tuple(got) == PATH_BANDS
        assert cfg.kpconv_knn_window_plan is None


@pytest.mark.parametrize("band", BANDS)
def test_plan_fits_the_card(built, band):
    """Shared memory within a block's and min_blocks blocks within the SM's;
    the coordinates 16-byte aligned; a warp's list, 32 lanes' candidates,
    and its slab of band words where that fits (every band of the seven
    paths); __launch_bounds__'s blocks of kTauRegs registers a thread
    within the SM's registers."""
    c, p = built["const"], built["plan"][band]
    assert p["smem"] <= SMEM_PER_BLOCK and p["min_blocks"] >= 1
    assert p["min_blocks"] * (p["smem"] + 1024) <= SMEM_PER_SM
    assert p["coord_bytes"] % 16 == 0 and p["coord_bytes"] >= 12 * band
    assert p["warps"] == c["warps"] and p["queries"] == c["queries"] <= 128
    slab = p["coord_bytes"] + p["warps"] * (c["list"] + 32 + band) * 4
    assert p["keep"] == (slab <= SMEM_PER_BLOCK)
    assert p["words"] == c["list"] + 32 + (band if p["keep"] else 0)
    assert c["list"] >= 32 and c["list"] % 32 == 0
    assert 1 <= c["walk"] <= 8
    assert p["smem"] == p["coord_bytes"] + p["warps"] * p["words"] * 4
    if band in PATH_BANDS:
        assert p["keep"], "every band of the seven paths keeps d2 once"
    # __launch_bounds__(threads, REGS_PER_SM / (regs * threads)) holds a
    # thread to regs registers, so that many blocks' registers fit an SM
    regs = c["regs"]
    threads = 32 * p["warps"]
    reg_blocks = REGS_PER_SM // (regs * threads)
    assert 1 <= reg_blocks and regs <= 255 and reg_blocks * regs * threads <= REGS_PER_SM


def test_max_band_recomputes_d2(built):
    """MAX_BAND (16384 rows): the coordinates fit (196608 bytes), a slab a
    warp does not, so the kernel runs in its recompute mode."""
    assert built["const"]["max_band"] == MAX_BAND
    p = built["plan"][MAX_BAND]
    assert not p["keep"] and p["smem"] <= SMEM_PER_BLOCK
    assert p["coord_bytes"] == 12 * MAX_BAND


def _fields(chain):
    """The digits of a chain of counting passes: bits [length - 1, shift] of
    hi - u a pass."""
    return [list(range(length - 1, shift - 1, -1)) for length, shift in chain]


@pytest.mark.parametrize("width", WIDTHS)
def test_counting_passes_take_each_bit_once(built, width):
    """From any width of the candidates' range, the counting passes take
    the top five bits of its bit length, each bin's width the next: their
    digits cover every bit below the width's length exactly once, at most
    five bits a pass, in at most seven passes."""
    chain = built["chain"][width]
    bits = [b for f in _fields(chain) for b in f]
    assert bits == list(range(width.bit_length() - 1, -1, -1))
    assert all(1 <= len(f) <= built["const"]["digit"] for f in _fields(chain))
    assert len(chain) <= 7


def test_the_digits_cover_bits_30_to_0(built):
    """The first pass's digit is bits 25..21 below the band's max (its
    lowest bin taking every row below: up to 2^31 - 1 patterns, whose
    passes cover bits 30..0); the other 31 bins leave 2^21 - 1, whose
    passes cover bits 20..0.  So every pattern a d2 can have (bits 30..0:
    bit 31 is a non-negative float's sign) is resolved."""
    first = built["const"]["first"]
    assert first + built["const"]["digit"] == 26
    assert [b for f in _fields(built["chain"][0x7FFFFFFF]) for b in f] == list(range(30, -1, -1))
    assert [b for f in _fields(built["chain"][(1 << first) - 1]) for b in f] == list(range(first - 1, -1, -1))


def _launcher(text, name):
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


def test_the_select_has_no_histogram_and_no_count_pass():
    """csrc/knn_tau.cu counts by ballots: no __match_any_sync call, no
    atomics, no histogram in shared memory; no pass counts the rows <= kth
    (the tie rule reads the last bin).  d2 is computed in one place a query
    walk (the d2 pass; the recompute mode's walks call the same lambda).
    The launcher takes no TQ and its block from tau_plan; the wrapper no
    longer picks one."""
    with open(os.path.join(cuda_lib.CSRC, "knn_tau.cu")) as fh:
        text = fh.read()
    code = re.sub(r"//[^\n]*", "", text)
    assert "__match_any_sync" not in code and "atomic" not in code and "hist" not in code
    assert code.count("membership_d2(") == 1 and "le +=" not in code
    assert "c > r" in text and "s.c > s.r" in code
    body = _launcher(code, "knn_tau_launch")
    assert "tau_plan(band)" in body and "QB" not in body.split("{")[0]
    assert len(cuda_lib.SIGNATURES["knn_tau_launch"]) == 12
    assert "pick_tq" not in inspect.getsource(banded_knn_tau_kernel)


@pytest.mark.parametrize("part", maxpool_knockout.TAU_PARTS + maxpool_knockout.TAU_CUTS)
def test_knockouts_apply_to_the_tau_source(part):
    """The knock-out tool's edits of #5 (its parts and its --cut builds)
    find their text once in csrc/knn_tau.cu, and a plan variant sets the
    tau plan's constants, so PERF.md's by-part timing of #5 can be run
    again."""
    assert maxpool_knockout.SOURCES["tau"][1] == "knn_tau.cu"
    with open(os.path.join(cuda_lib.CSRC, "knn_tau.cu")) as fh:
        text = fh.read()
    assert maxpool_knockout.patch(text, maxpool_knockout.KNOCKOUTS["knn_tau.cu"][part]) != text
    assert maxpool_knockout.plan_header(["tau"]) == "knn_tau_plan.cuh"
    with open(os.path.join(cuda_lib.CSRC, "knn_tau_plan.cuh")) as fh:
        header = fh.read()
    got = maxpool_knockout.patch(header, maxpool_knockout.plan_edits(header, "kTauWarps=16,kTauQueries=64"))
    assert "constexpr int kTauWarps = 16;" in got and "constexpr int kTauQueries = 64;" in got


def test_plan_header_stands_alone():
    """The plan header includes nothing, so a host compiler reads it."""
    with open(os.path.join(cuda_lib.CSRC, "knn_tau_plan.cuh")) as fh:
        assert "#include" not in fh.read()
