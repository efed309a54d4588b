"""A numpy model of kernel #5's select (csrc/knn_tau.cu) against the port's
plain ``banded_knn_tau`` (torch.topk) and the JAX package's.

The model runs the kernel's steps a warp at a time, with the constants of
its plan (csrc/knn_tau_plan.cuh, read from the header): d2 once per (query,
band row) as fp32 bit patterns; a first counting pass of 32 bins of
2^kTauFirstShift patterns below the band's max, the lowest bin taking the
rest; each bin counted by ballots (one a bit of the bin index, lane L
owning bin 31 - L, a lane's count the popcount of the AND) and chosen by a
32-lane scan; counting passes of the top 5 bits of the range's width, over
the band while the candidates outnumber the list (kTauListWords), then
over the list they are compacted into (ballot and popcount offsets) while
more than 32 are left; the last ones a lane, a ballot a bit until one is
left; the tie rule from the last bin (more than kk rows <= kth iff c > r)
and nxt from the list or a min walk over the band.  The kernel's modes (the patterns in
registers, every band of the seven paths; in a slab of shared memory; d2
again on each walk for bands whose slabs do not fit) differ only in where
a walk reads a row, so one model holds them all.  Everything is exact on bits, so every comparison
is bit-equality.

Cases: the 9 (query level, support level) bands of a `.t7` forward and a
`banded_knn` step (384 to 2304 rows), with M cut where the band allows;
windows from ``dynamic_knn_starts``; kk = band (the fallback); duplicated
points (the k-th and (k+1)-th distances tie); all points equal (every d2
+0, tau 1e-12).  Float clouds go through JAX op by op
(``jax.disable_jit``), as tests/test_torch_knn.py explains.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.ops import banded as tb
from cofii2p_tpu_torch.ops import cuda_lib
from tests.test_torch_knn import bits, clouds, j_tau

FULL = 0xFFFFFFFF
LANES = np.arange(32, dtype=np.uint64)


def _plan_constants():
    with open(os.path.join(cuda_lib.CSRC, "knn_tau_plan.cuh")) as fh:
        return {k: int(v) for k, v in re.findall(r"constexpr int (kTau\w+) = (-?\d+);", fh.read())}


PLAN = _plan_constants()
FIRST, DIGIT, LIST = PLAN["kTauFirstShift"], PLAN["kTauDigitBits"], PLAN["kTauListWords"]
X = np.stack([np.where((LANES >> i) & 1, FULL, 0) for i in range(5)]).astype(np.uint32)  # (5, 32)
LT = ((np.uint64(1) << LANES) - np.uint64(1)).astype(np.uint32)  # lanes below each lane


def ballot(pred):
    """(..., 32) bool -> (...) uint32: bit L set where lane L's predicate holds."""
    return (pred.astype(np.uint64) << LANES).sum(-1).astype(np.uint32)


def popc(x):
    return np.bitwise_count(np.asarray(x, np.uint32)).astype(np.int64)


def ffs_lane(mask):
    """__ffs(mask | bit 31) - 1: the lowest set lane, lane 31 if none."""
    mask = int(mask) | 0x80000000
    return (mask & -mask).bit_length() - 1


def walk(vals, n, fill):
    """The 32-row steps of a walk of a warp over the first n values: (steps,
    32) uint32 (``fill`` past n) and the live lanes."""
    steps = -(-n // 32)
    v = np.full(steps * 32, fill, np.uint32)
    v[:n] = vals[:n]
    return v.reshape(steps, 32), (np.arange(steps * 32) < n).reshape(steps, 32)


def bin_count(t, m):
    """Per lane, its bin's count over the steps: lane L owns bin t = 31 - L,
    a row is counted where the AND of the ballots of t's bits (XOR the
    lane's own bits) and the candidates' ballot ``m`` holds it."""
    mm = np.repeat(m[:, None], 32, 1)
    for i in range(5):
        mm &= ballot(((t >> np.uint32(i)) & np.uint32(1)).astype(bool))[:, None] ^ X[i]
    return popc(mm).sum(0)


class Range:
    def __init__(self, lo, hi, r, c):
        self.lo, self.hi, self.r, self.c = lo, hi, r, c


def choose_bin(cnt, shift, s):
    """The scan: the bin holding rank r becomes the range."""
    incl = np.cumsum(cnt)
    excl = incl - cnt
    own = ballot((excl < s.r) & (s.r <= incl))
    assert popc(own) == 1  # exactly one lane holds rank r
    src = ffs_lane(own)
    s.r -= int(excl[src])
    s.c = int(cnt[src])
    t = 31 - src
    if t < 31:
        s.lo = max(s.lo, s.hi - ((t + 1) << shift) + 1)
    s.hi -= t << shift


def select(u, kk, stats=None):
    """Kernel #5's select of one query over its band's d2 patterns ``u``
    (uint32): returns (kth, nxt) as patterns, nxt None for the fallback.
    Every mode of the kernel runs it (they differ in where a walk reads
    ``u``: registers, the slab, or d2 again)."""
    band = len(u)
    s = Range(0, int(u.max()), kk, band)
    # the first pass: every row a candidate, quarter binades below the max
    v, live = walk(u, band, 0)
    d = np.minimum(np.uint32(s.hi) - v, np.uint32((32 << FIRST) - 1))  # bin 31: the lowest, holding the rest
    choose_bin(bin_count(d >> np.uint32(FIRST), ballot(live)), FIRST, s)
    c_first, passes, list_passes = s.c, 0, 0

    def count_pass(vals, n):
        w = s.hi - s.lo
        shift = max(0, w.bit_length() - DIGIT)
        v, live = walk(vals, n, 0)
        inn = live & ((v - np.uint32(s.lo)) <= np.uint32(w))
        choose_bin(bin_count((np.uint32(s.hi) - v) >> np.uint32(shift), ballot(inn)), shift, s)

    def compact(vals, n, cap):
        """The rows of [lo, hi] among the first n, in order, by ballot and
        popcount offsets."""
        v, live = walk(vals, n, 0)
        inn = live & ((v - np.uint32(s.lo)) <= np.uint32(s.hi - s.lo))
        bal = ballot(inn)
        base = np.concatenate([[0], np.cumsum(popc(bal))])
        pos = base[:-1, None] + popc(bal[:, None] & LT[None, :])
        assert base[-1] == s.c <= cap and (pos[inn] == np.arange(s.c)).all()  # every candidate, in order
        out = np.zeros(s.c, np.uint32)
        out[pos[inn]] = v[inn]
        return out

    # counting passes over the band while the candidates outnumber the list
    while s.lo != s.hi and s.c > LIST:
        assert passes < 7
        count_pass(u, band)
        passes += 1
    listed = np.zeros(0, np.uint32)
    if s.lo != s.hi:
        listed = compact(u, band, LIST)
        while s.lo != s.hi and s.c > 32:  # then over the list
            assert list_passes < 7
            count_pass(listed, len(listed))
            list_passes += 1
    registers = s.lo != s.hi
    if registers:  # at most 32 candidates, one a lane: a ballot a bit of u - lo
        w = s.hi - s.lo
        ul = np.zeros(32, np.uint32)
        lanes = compact(listed, len(listed), 32)
        ul[:len(lanes)] = lanes
        vv = ul - np.uint32(s.lo)
        cm = (1 << len(lanes)) - 1
        for bit in range(w.bit_length() - 1, -1, -1):
            if not cm & (cm - 1):  # one candidate left: it is kth (c = 1, r = 1)
                break
            ones = int(ballot(((vv >> np.uint32(bit)) & np.uint32(1)).astype(bool))) & cm
            zeros = int(popc(cm)) - int(popc(ones))
            if s.r <= zeros:
                cm &= ~ones & FULL
            else:
                s.r -= zeros
                cm = ones
        s.c = int(popc(cm))
        s.lo = s.hi = int(ul[ffs_lane(cm)])
    kth = s.lo
    tie = s.c > s.r  # the rows <= kth are (kk - r) + c
    walked = False
    if tie:
        nxt = kth
    elif kk < band:
        above = listed[listed > np.uint32(kth)]  # the list is every row of its range
        if above.size:
            nxt = int(above.min())
        else:  # a min walk over the band
            walked = True
            nxt = int(u[u > np.uint32(kth)].min())
    else:
        nxt = None
    if stats is not None:
        stats.append(dict(first=c_first, passes=passes, list_passes=list_passes, registers=registers, tie=tie,
                          walked=walked))
    return kth, nxt


def tau_of(kth, nxt):
    """The epilogue, rounding each fp32 operation as the kernel does."""
    f32 = np.float32
    k = np.uint32(kth).view(np.float32)
    n = k * f32(1.0 + 2e-6) + f32(2e-12) if nxt is None else np.uint32(nxt).view(np.float32)
    return max(f32(0.5) * (k + n), k * f32(1.0 + 1e-5) + f32(1e-12))


def tile_d2_bits(q, s, t, tile, start, band):
    """(tile, band) d2 patterns of tile t: both clouds centred on the
    tile's first query, per-dimension differences squared, added in order."""
    ref = q[t * tile]
    qc, pc = q[t * tile:(t + 1) * tile] - ref, s[start:start + band] - ref
    d2 = None
    for d in range(3):
        diff = qc[:, None, d] - pc[None, :, d]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    assert d2.dtype == np.float32
    return d2.view(np.uint32)


def model_tau(q, s, k, bw, starts=None, tiles=None, stats=None):
    """tau of one frame's tiles (default: all) through the model; (M,)
    float32 with NaN outside the tiles taken."""
    m, n = len(q), len(s)
    tile, num_tiles, band = tb.band_plan(m, n, 128, bw, None if starts is None else True)
    st = tb._band_starts_np(m, n, tile, band, num_tiles) if starts is None else starts
    kk = min(k, band)
    out = np.full(m, np.nan, np.float32)
    for t in range(num_tiles) if tiles is None else tiles:
        d2 = tile_d2_bits(q, s, t, tile, int(st[t]), band)
        for i in range(tile):
            out[t * tile + i] = tau_of(*select(d2[i], kk, stats))
    return out


def first_middle_last(m):
    nt = tb.band_plan(m, m, 128, 1)[1]
    return sorted({0, nt // 2, nt - 1})


def plain(q, s, k, bw, starts=None):
    return tb.banded_knn_tau(torch.as_tensor(q[None]), torch.as_tensor(s[None]), k, 128, bw,
                             None if starts is None else torch.as_tensor(starts[None])).numpy()[0]


def jax_op_by_op(q, s, k, bw, starts=None):
    with jax.disable_jit():
        return j_tau(q[None], s[None], k, bw, None if starts is None else starts[None])[0]


# (query level <- support level: M, N, band width) of the 9 tau calls of a
# `.t7` forward and a `banded_knn` step (pyramid 20480 .. 1280, band plan
# 128 / 256 / 640 / 1024 / 2560), M and N cut with the band unchanged
PAIRS = {
    "lvl0<-lvl0": (1024, 1024, 128, 384), "lvl1<-lvl1": (1024, 1024, 256, 640),
    "lvl2<-lvl2": (1536, 1536, 640, 1408), "lvl3<-lvl3": (2304, 2304, 1024, 2176),
    "lvl4<-lvl4": (1280, 1280, 2560, 1280), "lvl1<-lvl0": (512, 1024, 128, 512),
    "lvl2<-lvl1": (512, 1024, 256, 768), "lvl3<-lvl2": (1024, 2048, 640, 1536),
    "lvl4<-lvl3": (1280, 2560, 1024, 2304),
}
K = 128


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_model_bitequal_at_the_path_bands(pair):
    """Each of the 9 bands of the k-NN paths, on a float cloud with
    duplicated points: the model's tau on the first, middle and last tiles
    has the bits of the port's plain version and of JAX's; the first
    pass, the compaction and the register passes all run."""
    m, n, bw, band = PAIRS[pair]
    assert tb.band_plan(m, n, 128, bw)[2] == band
    q, s = (x[0] for x in clouds(m, n, seed=band))
    tiles = first_middle_last(m)
    stats = []
    got = model_tau(q, s, K, bw, tiles=tiles, stats=stats)
    rows = np.concatenate([np.arange(t * 128, (t + 1) * 128) for t in tiles])
    want = plain(q, s, K, bw)
    np.testing.assert_array_equal(bits(got[rows]), bits(want[rows]))
    np.testing.assert_array_equal(bits(want), bits(jax_op_by_op(q, s, K, bw)))
    assert sum(st["registers"] for st in stats) > len(stats) // 2


def test_model_takes_the_tie_rule_on_duplicated_points():
    """On clouds whose every 9th row repeats its predecessor, some queries'
    k-th and (k+1)-th distances tie: the model finds them by c > r, and its
    tau still has the plain version's bits (the (k+1)-th value is kth)."""
    q, s = (x[0] for x in clouds(1024, 1024, seed=7, grid=True))
    stats = []
    got = model_tau(q, s, 16, 64, stats=stats)
    np.testing.assert_array_equal(bits(got), bits(plain(q, s, 16, 64)))
    assert sum(st["tie"] for st in stats) >= 8


def test_model_on_knn_windows():
    """Windows from dynamic_knn_starts (a tile's width-256 window, k = 16):
    the model, the plain version and JAX agree bit for bit."""
    q, s = (x[0] for x in clouds(1024, 2048, seed=11))
    tau2 = tb.banded_knn_tau(torch.as_tensor(q[None]), torch.as_tensor(s[None]), 16, 128, 512)
    starts = tb.dynamic_knn_starts(torch.as_tensor(q[None]), torch.as_tensor(s[None]), tau2, 128, 256, 1).numpy()[0]
    got = model_tau(q, s, 16, 256, starts=starts)
    want = plain(q, s, 16, 256, starts)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(want), bits(jax_op_by_op(q, s, 16, 256, starts)))


def test_model_kk_equals_band():
    """A band of the whole level with k = band (128 rows): no (k+1)-th row,
    the fallback nxt."""
    q, s = (x[0] for x in clouds(128, 128, seed=3))
    got = model_tau(q, s, 128, 256)
    want = plain(q, s, 128, 256)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(want), bits(jax_op_by_op(q, s, 128, 256)))


@pytest.mark.parametrize("k,band", [(128, 384), (16, 128), (128, 128)])
def test_model_all_points_equal(k, band):
    """Every point the same: every d2 is +0, the first pass collapses to
    one pattern, and tau is 1e-12 (a tie, or the fallback at kk = band)."""
    q = np.full((band, 3), 3.25, np.float32)
    got = model_tau(q, q, k, band)
    want = plain(q, q, k, band)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (want == np.float32(1e-12)).all()


def test_model_takes_the_rare_branches():
    """At the widest band (lvl4 <- lvl3, 2304 rows) some queries' first bin
    holds more than 32 rows, so a counting pass over the list runs before
    the last 32 go to the lanes, and some queries' (k+1)-th value lies
    above the listed range, so nxt comes from the min walk over the band;
    their tau too has the plain version's bits."""
    m, n, bw, _ = PAIRS["lvl4<-lvl3"]
    q, s = (x[0] for x in clouds(m, n, seed=5))
    stats = []
    got = model_tau(q, s, K, bw, stats=stats)
    np.testing.assert_array_equal(bits(got), bits(plain(q, s, K, bw)))
    assert sum(st["list_passes"] > 0 for st in stats) >= 4
    assert sum(st["walked"] for st in stats) >= 4
