// Banded k-NN threshold (tau) for Hopper: kernel #5.
//
// Replaces: cofii2p_tpu/ops/tau_kernel.py::banded_knn_tau_pallas (body
// _tau_bisect_kernel).  Same function: for each query m of a band tile,
// with d2 the squared distances to the tile's band rows (centred on the
// tile's first query, dimensions added in order 0, 1, 2, no fused
// multiply-add: common.cuh), kk = min(k, band), kth and nxt the kk-th and
// (kk+1)-th smallest d2,
//   tau[m] = max(0.5 * (kth + nxt), kth * (1 + 1e-5) + 1e-12),
// with nxt = kth * (1 + 2e-6) + 2e-12 where the band has no (kk+1)-th row.
// kth and nxt are data values, found exactly, so tau is bit-equal to the
// plain version (ops/banded.py::banded_knn_tau, torch.topk).
//
// What bounds it on the H100: the instructions issued a (query, band row)
// pair and their latency, not memory (it reads each band's coordinates
// once and writes 4 bytes a query); d2's arithmetic runs on the FP32 pipe
// beside the select's integer and vote instructions.  The tensor cores
// cannot take d2: it must be the per-dimension `_rn` arithmetic of
// membership_d2 for tau's bits.  The TPU kernel bisected 48 times on a
// (tile, band) block of d2 in VMEM.  Here a block stages its band's
// centred coordinates once, each warp takes one query at a time, and
// (plan in knn_tau_plan.cuh):
//  - d2 is computed once per (query, band row) and its fp32 bit pattern
//    kept in a slab of shared memory (non-negative floats order as their
//    uint32 bits); every later walk reads bits, not coordinates.  Bands
//    whose slabs do not fit recompute d2 on each walk (the same kernel,
//    KEEP off).  (In registers, a lane the rows lane, 32 + lane, ..., the
//    patterns lost to the slab at every band over 512 rows: PERF.md.)
//  - The k-th pattern is found by a radix select over ranges of bit
//    patterns: a counting pass splits the candidates lo <= u <= hi into 32
//    bins t = (hi - u) >> shift, one a lane, counted by warp ballots (one
//    ballot per bit of t, then each lane the popcount of its bin's AND
//    with the candidates' lanes), and a 32-lane scan picks the bin holding
//    the rank sought.  No __match_any_sync, no atomics: the same bits on
//    every launch.  The first pass's bins are quarter binades below the
//    band's max (the lowest takes every row below them); on the paths'
//    clouds that leaves about 20-30 candidates of a band of hundreds or
//    thousands.
//  - Passes shrink to the candidates: once at most kTauListWords (256) are
//    left, one walk compacts them into a list (ballot and popcount offsets,
//    skipping the many steps that hold none), later passes walk the list,
//    and the last <= 32 sit one a lane in registers, where one ballot a bit
//    finishes the select.  Walks load four 32-row steps before they count
//    them.
//  - The tie rule from the last bin: at the end the bin is kth exactly, so
//    the rows <= kth number (kk - r) + c, c the bin's count and r the rank
//    in it, and "more than kk rows <= kth" is c > r.  Only without a tie
//    and with kk < band is nxt still needed: the least pattern above kth,
//    in the list when it holds one (the list is every row of its range),
//    else from a min walk over the band.

#include "common.cuh"
#include "knn_tau_plan.cuh"

namespace {

constexpr int kThreads = cofii2p::kTauWarps * 32;
constexpr int kMinBlocks = cofii2p::kTauRegsPerSM / (cofii2p::kTauRegs * kThreads);
constexpr unsigned kFull = 0xffffffffu;

struct Range {     // a warp's select state, the same in every lane
  unsigned lo, hi;  // the candidates: lo <= u <= hi
  int r;            // rank sought among them, from 1
  int c;            // candidates in [lo, hi]
};

// The lanes of rows [j0, j0 + 32) below n (j0 < n).
__device__ __forceinline__ unsigned live_lanes(int n, int j0) {
  return n - j0 >= 32 ? kFull : (1u << (n - j0)) - 1u;
}

// A warp's walk over rows [0, n): load(j) gives row j's pattern, step(u,
// live) takes one 32-row step (live: the lanes holding a row).  Whole
// groups of U steps load before they are taken, unguarded; the ragged
// tail goes a step at a time.
template <int U, class Load, class Step>
__device__ __forceinline__ void walk_rows(int n, int lane, const Load& load, const Step& step) {
  int j0 = 0;
  for (; j0 + 32 * U <= n; j0 += 32 * U) {
    unsigned u[U];
#pragma unroll
    for (int k = 0; k < U; ++k) u[k] = load(j0 + 32 * k + lane);
#pragma unroll
    for (int k = 0; k < U; ++k) step(u[k], kFull);
  }
  for (; j0 < n; j0 += 32) step(j0 + lane < n ? load(j0 + lane) : 0u, live_lanes(n, j0));
}

// One 32-row step of a counting pass: t the row's bin (counted down from
// hi), `m` the lanes whose row is a candidate; returns the lane's count of
// its bin (lane L owns bin t = 31 - L: bins in ascending order of u).  x[i]
// is all ones where lane L has bit i set (t's bit i is then 0); bit[i] is
// 1 << i, held in a register: against constants the compiler tests each
// bit with a shift, a mask and a compare, against these it loads all five
// into predicates with one R2P.
__device__ __forceinline__ int bin_count(unsigned t, unsigned m, const unsigned (&x)[5],
                                         const unsigned (&bit)[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) m &= __ballot_sync(kFull, (t & bit[i]) != 0u) ^ x[i];
  return __popc(m);
}

// After a counting pass of bins of 2^shift: the bin holding rank r (lane
// L's count cnt of bin t = 31 - L) becomes the new range.
__device__ __forceinline__ void choose_bin(int cnt, int lane, int shift, Range& s) {
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - cnt;
  // one lane holds rank r (bit 31 only keeps a knocked-out build's select in range)
  const int src = __ffs(__ballot_sync(kFull, excl < s.r && s.r <= incl) | 0x80000000u) - 1;
  s.r -= __shfl_sync(kFull, excl, src);
  s.c = __shfl_sync(kFull, cnt, src);
  const unsigned t = 31u - static_cast<unsigned>(src);
  if (t < 31u) {  // bin 31 reaches down to lo
    const long long lo = static_cast<long long>(s.hi) - (static_cast<long long>(t + 1u) << shift) + 1;
    if (lo > static_cast<long long>(s.lo)) s.lo = static_cast<unsigned>(lo);
  }
  s.hi -= t << shift;
}

// KEEP: the band's patterns in a slab of shared memory a warp; else d2
// computed again on each walk.
template <bool KEEP>
__global__ void __launch_bounds__(kThreads, kMinBlocks) knn_tau_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int* __restrict__ starts, float* __restrict__ tau, int M, int N,
    int tile, int num_tiles, int band, int QB, int kk, int coord_floats) {
  constexpr int kList = cofii2p::kTauListWords;
  constexpr int kWalk = cofii2p::kTauWalk;
  constexpr int kFirst = cofii2p::kTauFirstShift;
  constexpr unsigned kFirstClamp = (32u << kFirst) - 1u;  // bits [kFirst, kFirst + 5) all set: bin 31
  extern __shared__ float4 smem4[];
  float* band_s = reinterpret_cast<float*>(smem4);  // band * 3, centred
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp's list of kList candidates, its 32 lanes' candidates, then its
  // slab of band patterns
  unsigned* list = reinterpret_cast<unsigned*>(band_s + coord_floats) + warp * (kList + 32 + (KEEP ? band : 0));
  unsigned* lanes = list + kList;
  unsigned* slab = lanes + 32;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QB;
  const int t = m0 / tile;
  const int start = starts[b * num_tiles + t];
  const float* ref = q_pts + ((long)b * M + (long)t * tile) * 3;
  const float* srow = s_pts + ((long)b * N + start) * 3;
#pragma unroll 4
  for (int i = tid; i < band * 3; i += kThreads) band_s[i] = __fsub_rn(srow[i], ref[i % 3]);
  __syncthreads();

  unsigned x[5], bit[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    x[i] = (lane >> i) & 1 ? kFull : 0u;
    bit[i] = __shfl_sync(kFull, 1u << i, 0);
  }
  const unsigned lt = (1u << lane) - 1u;
  const float c_pad = (float)(1.0 + 1e-5), e_pad = (float)1e-12;
  const float c_fb = (float)(1.0 + 2e-6), e_fb = (float)2e-12;

  for (int q = warp; q < QB; q += cofii2p::kTauWarps) {
    const float* qp = q_pts + ((long)b * M + m0 + q) * 3;
    float qc[3];
    for (int d = 0; d < 3; ++d) qc[d] = __fsub_rn(qp[d], ref[d]);
    auto d2_bits = [&](int j) {
      return __float_as_uint(cofii2p::membership_d2(qc, band_s[3 * j], band_s[3 * j + 1], band_s[3 * j + 2]));
    };
    // the one d2 of (query, row), as its pattern
    auto d2_once = [&](int j) { return d2_bits(j); };

    // d2 of every band row, once (KEEP: into the slab), and the band's max
    unsigned mx = 0u;
#pragma unroll 4
    for (int j = lane; j < band; j += 32) {
      const unsigned u = d2_once(j);
      if (KEEP) slab[j] = u;
      mx = max(mx, u);
    }
    Range s{0u, __reduce_max_sync(kFull, mx), kk, band};
    // a walk over the band: step(u, live) a 32-row step at a time
    auto band_walk = [&](const auto& step) {
      walk_rows<kWalk>(band, lane, [&](int j) { return KEEP ? slab[j] : d2_bits(j); }, step);
    };
    // ... and over the first n rows of the list
    auto list_walk = [&](int n) {
      return [&, n](const auto& step) { walk_rows<kWalk>(n, lane, [&](int j) { return list[j]; }, step); };
    };

    // the first pass: every row a candidate, bins of 2^kFirst patterns
    // below the max, the lowest bin taking every row below them
    {
      const unsigned hi = s.hi;
      int cnt = 0;
      band_walk([&](unsigned u, unsigned live) { cnt += bin_count(min(hi - u, kFirstClamp) >> kFirst, live, x, bit); });
      choose_bin(cnt, lane, kFirst, s);
    }
    // counting passes: over the band while the candidates outnumber the
    // list, then over the list while more than 32 are left; each divides
    // the range's width by 32
    auto count_pass = [&](const auto& walk) {
      const unsigned lo = s.lo, hi = s.hi, w = hi - lo;
      const int shift = max(0, 32 - __clz(w) - cofii2p::kTauDigitBits);
      int cnt = 0;
      walk([&](unsigned u, unsigned live) {
        cnt += bin_count((hi - u) >> shift, __ballot_sync(kFull, u - lo <= w) & live, x, bit);
      });
      choose_bin(cnt, lane, shift, s);
    };
    // the rows of [lo, hi] a walk meets, in order, into dst (ballot and
    // popcount offsets; most steps hold none); returns how many
    auto compact = [&](const auto& walk, unsigned* dst, int cap) {
      const unsigned lo = s.lo, w = s.hi - s.lo;
      int m = 0;
      walk([&](unsigned u, unsigned live) {
        const unsigned bal = __ballot_sync(kFull, u - lo <= w) & live;
        if (bal) {
          const int pos = m + __popc(bal & lt);
          if (((bal >> lane) & 1u) && pos < cap) dst[pos] = u;
          m += __popc(bal);
        }
      });
      __syncwarp();
      return min(m, cap);
    };
    for (int pass = 0; pass < 7 && s.lo != s.hi && s.c > kList; ++pass) count_pass(band_walk);
    int n = 0;  // rows listed: every row of the range when the list was made
    if (s.lo != s.hi) {
      n = compact(band_walk, list, kList);
      for (int pass = 0; pass < 7 && s.lo != s.hi && s.c > 32; ++pass) count_pass(list_walk(n));
    }

    // at most 32 candidates: one a lane, and a ballot a bit of u - lo
    if (s.lo != s.hi) {
      const unsigned lo = s.lo, w = s.hi - s.lo;
      const int nl = compact(list_walk(n), lanes, 32);
      const unsigned ul = lane < nl ? lanes[lane] : 0u;
      const unsigned v = ul - lo;
      unsigned cm = __ballot_sync(kFull, lane < nl);
      // down to the last bit, or until one candidate is left (c = 1, r = 1);
      // the bit tested held in a register, as bin_count's
      unsigned mask = __shfl_sync(kFull, 0x80000000u >> __clz(w), 0);
      for (; mask != 0u && (cm & (cm - 1u)); mask >>= 1) {
        const unsigned ones = __ballot_sync(kFull, (v & mask) != 0u) & cm;
        const int zeros = __popc(cm) - __popc(ones);
        if (s.r <= zeros) {
          cm &= ~ones;
        } else {
          s.r -= zeros;
          cm = ones;
        }
      }
      s.c = __popc(cm);
      s.lo = s.hi = __shfl_sync(kFull, ul, __ffs(cm | 0x80000000u) - 1);
    }

    // the tie rule from the last bin: the rows <= kth are (kk - r) + c
    const float kth = __uint_as_float(s.lo);
    float nxt;
    if (s.c > s.r) {
      nxt = kth;  // the (kk+1)-th value ties the kk-th
    } else if (kk < band) {
      // the least pattern above kth: in the list if it holds one (the list
      // is every row of its range), else from a min walk over the band
      auto least_above = [&](const auto& walk) {
        unsigned least = kFull;
        walk([&](unsigned u, unsigned live) {
          if (((live >> lane) & 1u) && u > s.lo) least = min(least, u);
        });
        return __reduce_min_sync(kFull, least);
      };
      unsigned least = least_above(list_walk(n));
      if (least == kFull) least = least_above(band_walk);
      nxt = __uint_as_float(least);
    } else {
      nxt = __fadd_rn(__fmul_rn(kth, c_fb), e_fb);  // no (kk+1)-th row
    }
    const float mid = __fmul_rn(0.5f, __fadd_rn(kth, nxt));
    const float pad = __fadd_rn(__fmul_rn(kth, c_pad), e_pad);
    if (lane == 0) tau[(long)b * M + m0 + q] = fmaxf(mid, pad);
    __syncwarp();
  }
}

template <bool KEEP>
int launch(const cofii2p::TauPlan& plan, dim3 grid, cudaStream_t stream, const float* q, const float* s,
           const int* starts, float* tau, int M, int N, int tile, int num_tiles, int band, int qb, int kk) {
  if (plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(knn_tau_kernel<KEEP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  knn_tau_kernel<KEEP><<<grid, kThreads, plan.smem, stream>>>(q, s, starts, tau, M, N, tile, num_tiles, band, qb,
                                                              kk, plan.coord_bytes / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, M, 3) fp32, s (B, N, 3) fp32, starts (B, num_tiles) int32 (each
// tile's band of ``band`` rows); tau (B, M) fp32.  1 <= kk <= band <=
// kTauMaxBand; the queries a block come from the plan, halved until they
// divide the tile.
extern "C" int knn_tau_launch(const void* q, const void* s, const void* starts,
                              void* tau, int B, int M, int N, int tile,
                              int num_tiles, int band, int kk, void* stream) {
  if (tile < 1 || M != tile * num_tiles || band > N || band < 1 || band > cofii2p::kTauMaxBand ||
      kk < 1 || kk > band)
    return static_cast<int>(cudaErrorInvalidValue);
  const cofii2p::TauPlan plan = cofii2p::tau_plan(band);
  int qb = plan.queries < tile ? plan.queries : tile;
  while (tile % qb) qb /= 2;  // a tile is a power of two, or M < 128 whole
  dim3 grid(M / qb, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* sf = static_cast<const float*>(s);
  const int* so = static_cast<const int*>(starts);
  float* out = static_cast<float*>(tau);
  return plan.keep ? launch<true>(plan, grid, st, qf, sf, so, out, M, N, tile, num_tiles, band, qb, kk)
                   : launch<false>(plan, grid, st, qf, sf, so, out, M, N, tile, num_tiles, band, qb, kk);
}
