// The transposed banded KPConv aggregation on the tensor cores, fp32 by
// 3xTF32 and bf16: the feature gradient of the banded aggregation on static
// bands (kernel #9), on dynamic windows (kernel #10) and under the k-NN
// (tau) semantics (kernel #11), launched from kpconv_transpose.cu.
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::_transpose_agg (body
// _agg_bwd_kernel), _transpose_agg_dyn (_agg_bwd_dyn_kernel) and
// _transpose_agg_tau (_agg_bwd_kernel_tau).  For each support row j:
//   g_feats[j, :] = sum_m sum_k infl_k(q_m, s_j) g[m, k, :]
// over the queries m whose band holds j (start(tile(m)) <= j <
// start(tile(m)) + band) and whose membership test holds, d2 centred on the
// first query of m's 128-row band tile exactly as the forward computes it:
//  - RadiusMember (#9, #10): d2 <= r2, r2 the squared kernel reach, kp the
//    shared kernel points;
//  - TauMember (#11): d2 <= r2 and d2 <= tau[m], r2 the padded reach of
//    ops/banded.py::tau_reach2, kp the layer's own kernel points.
//
// What bounds it on the H100: reading g, the (B, M, 15, C) fp32 cotangent
// of the aggregate (up to 315 MB a call at B = 8), and the product, 2 * 15
// * C multiply-adds per member (query, support) pair.  It is the forward
// aggregation with the roles swapped: the A operand is the (support rows,
// listed queries) influence tile, the B operand the listed queries' g rows
// at kernel point k (row stride K * C).  On the TPU kernel's plan (no
// atomics):
//  - static bands (WINDOW off; #9, #11): a block owns TS = 64 support rows
//    and at most 256 channels (TransposePlan), and walks the contiguous
//    window of query tiles whose bands touch its rows
//    (ops/banded.py::bwd_geometry, computed on the host), so a g row is
//    read by band / 64 blocks; the sums go to (B, N, C);
//  - windows (WINDOW on; #10): under per-tile data-dependent starts there
//    is no static plan from support rows to query tiles, so a block owns
//    TS rows of ONE query tile t's window (blockIdx.x = t * (band / TS) +
//    chunk, rows starts[b, t] + chunk * TS ..) and writes their sums to
//    the tile's slice of a (B, num_tiles, band, C) stack, every element
//    once; band_scatter.cu then adds the overlapping windows in tile
//    order, as the TPU's _scatter_band_stacks does;
//  - membership runs once a block and query tile: each (query, row) pair's
//    d2 and member test, centred with the _rn intrinsics, kept as one
//    64-bit word a query (a bit a support row); the queries with any bit
//    form one ordered list over the tiles of kTransposeQSeg window queries
//    (every window of the FPN; a longer one is walked in segments), kept
//    across the 15 kernel points, so the influence pass tests a bit and
//    recomputes nothing;
//  - the product runs on mma.sync (mma.cuh's aggregate_tf32x3 and
//    aggregate_bf16): for kernel point k and a chunk of RB listed queries
//    the (TS, RB) influence tile, computed in fp32 from the uncentred
//    offsets, is A; the chunk's g rows at k, staged by 16-byte cp.async
//    and double buffered (the next chunk in flight while this one's
//    influence is computed), are B; the (TS, CB) sums accumulate in fp32
//    fragments over every kernel point and tile and are stored once;
//  - fp32 (round = 0) multiplies by 3xTF32 (mma.cuh: each operand split
//    into tf32 hi + lo, the influence once where it is computed, g at its
//    fragment loads; the three products of a k-step chained from zero and
//    added to the accumulator with round-to-nearest); bf16 (round = 1) is
//    one bf16 mma with the influence and g rounded to bf16 before their
//    product, the TPU backward's rounding points.
// The sums run in a fixed order and every output element is written once
// by one block, so the result is the same bits from run to run.
//
// Exactness: membership is bit-identical to the forward's (the same
// centring, cofii2p::membership_d2, the same band, reach and tau), so no
// pair is dropped or added; the influence takes its offset from the
// uncentred coordinates, as the forward kernels do, and its distance as
// d2 * rsqrtf(d2) (a few ulps from the plain version's sqrt); the fp32
// sums run in another order than the plain version's.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kpconv_mma_plan.cuh"
#include "mma.cuh"

namespace cofii2p {

// q (B, M, 3), s (B, N, 3), g (B, M, K, C) fp32, kp (K, 3) fp32, starts
// (B, num_tiles) int32 band starts (static) or window starts; static bands:
// qstart_blk (N / TS) int32 each support tile's first query tile of its
// window of n_qtiles tiles, out (B, N, C) fp32; windows: qstart_blk unused,
// out the (B, num_tiles, band, C) fp32 stack.  tau (B, M) fp32 for
// TauMember, else unused.
struct TransposeArgs {
  const float* q;
  const float* s;
  const float* g;
  const float* kp;
  const int* starts;
  const int* qstart_blk;
  const float* tau;
  float* out;
  int B, M, N, C, K, tile, num_tiles, band, TS, n_qtiles;
  float r2, sigma;
  cudaStream_t st;
};

}  // namespace cofii2p

namespace {

constexpr int kTrThreads = cofii2p::kMmaThreads;

// Radius membership of a (query, support row) pair (#9, #10): within the
// kernel reach; no per-query threshold
struct RadiusMember {
  __device__ __forceinline__ float threshold(long) const { return 0.f; }
  __device__ __forceinline__ bool member(float d2, float r2, float) const { return d2 <= r2; }
};

// k-NN membership of a (query, support row) pair (#11): within the padded
// reach and within the query's tau
struct TauMember {
  const float* tau;
  __device__ __forceinline__ float threshold(long bm) const { return tau[bm]; }
  __device__ __forceinline__ bool member(float d2, float r2, float thr) const { return d2 <= r2 && d2 <= thr; }
};

// grid (N / TS, B, ceil(C / CB)) on static bands, (num_tiles * band / TS,
// B, ceil(C / CB)) in WINDOW mode; kTrThreads threads, TransposePlan<CB,
// F32>::SMEM bytes of dynamic shared memory.  a.TS (runtime) divides N
// (band in WINDOW mode) and is at most the plan's; a.tile <= 128.
template <int CB, bool F32, bool WINDOW, class Member>
__global__ void __launch_bounds__(kTrThreads, (cofii2p::TransposePlan<CB, F32>::MIN_BLOCKS))
    kpconv_transpose_mma_kernel(const cofii2p::TransposeArgs a, const Member member) {
  using P = cofii2p::TransposePlan<CB, F32>;
  using E = typename std::conditional<F32, float, __nv_bfloat16>::type;  // a staged operand
  constexpr int kSeg = cofii2p::kTransposeQSeg;
  extern __shared__ __align__(16) unsigned char smem[];
  E* F_s = reinterpret_cast<E*>(smem);
  // the influence tile: bf16, or fp32 split into tf32 hi (A_hi) and lo
  E* A_s = reinterpret_cast<E*>(smem + P::F_BYTES);
  uint32_t* A_hi = reinterpret_cast<uint32_t*>(A_s);
  uint32_t* A_lo = A_hi + P::TS * P::A_STRIDE;
  // per window query of the segment: its membership word, low half rows 0-31
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + P::F_BYTES + P::A_BYTES);
  unsigned short* list = reinterpret_cast<unsigned short*>(bits + 2 * kSeg);
  float* pq_s = reinterpret_cast<float*>(list + kSeg);  // [slot][RB][3]
  float* sp_s = pq_s + 2 * P::RB * 3;                   // the block's rows
  float* pc_s = sp_s + P::TS * 3;                       // ... centred on a tile's first query
  int* warp_tot = reinterpret_cast<int*>(pc_s + P::TS * 3);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group and column
  const int b = blockIdx.y;
  const int TS = a.TS;
  const int c0 = blockIdx.z * CB;
  const int ncols = min(a.C - c0, CB);
  const int tile = a.tile;
  // static bands: support rows s0 .. s0 + TS of (B, N) and the query tiles
  // t_first .. t_end whose bands touch them; WINDOW: rows row0 .. row0 + TS
  // of tile t_first's window, and that tile alone
  const int per_tile = WINDOW ? a.band / TS : 1;
  const int t_first = WINDOW ? blockIdx.x / per_tile : a.qstart_blk[blockIdx.x];
  const int row0 = WINDOW ? (blockIdx.x % per_tile) * TS : 0;
  const int s0 = WINDOW ? a.starts[b * a.num_tiles + t_first] + row0 : blockIdx.x * TS;
  const int t_end = WINDOW ? t_first + 1 : min(t_first + a.n_qtiles, a.num_tiles);
  const long KC = (long)a.K * a.C;

  for (int i = tid; i < P::TS * 3; i += kTrThreads) sp_s[i] = i < TS * 3 ? a.s[((long)b * a.N + s0) * 3 + i] : 0.f;

  const int wm = warp / P::WNA, wn = warp % P::WNA;  // this warp's fragments of the sums
  float acc[P::MA][P::NA][4];
#pragma unroll
  for (int i = 0; i < P::MA; ++i)
#pragma unroll
    for (int j = 0; j < P::NA; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const bool g_vec = cofii2p::stage_vec<E>(a.g, 0, a.C);
  const float inv_sigma = 1.f / a.sigma;
  const int tiles_per_seg = kSeg / tile;
  for (int tseg = t_first; tseg < t_end; tseg += tiles_per_seg) {
    const int tseg_end = min(t_end, tseg + tiles_per_seg);
    const int mseg = tseg * tile;  // the segment's first query
    // membership of the segment's tiles: the words of every query of a
    // tile that reaches the block, and the ordered list of those with a bit
    int n_list = 0;
    for (int t = tseg; t < tseg_end; ++t) {
      const int start = a.starts[b * a.num_tiles + t];
      // rows lo..hi of the block lie in tile t's band (WINDOW: all TS rows,
      // since the block's rows are a slice of that window)
      const int lo = max(start - s0, 0), hi = min(start + a.band - s0, TS);
      if (lo >= hi) continue;
      const float* ref_p = a.q + ((long)b * a.M + (long)t * tile) * 3;
      __syncthreads();  // the previous tile's words are done with pc_s (and sp_s is loaded)
      for (int i = tid; i < P::TS * 3; i += kTrThreads) pc_s[i] = __fsub_rn(sp_s[i], ref_p[i % 3]);
      __syncthreads();
      // item (query q, half h) tests rows 32h .. 32h + 31
      for (int idx = tid; idx < tile * 2; idx += kTrThreads) {
        const int q = idx % tile, h = idx / tile;
        const long bm = (long)b * a.M + (long)t * tile + q;
        float qc[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) qc[d] = __fsub_rn(a.q[bm * 3 + d], ref_p[d]);
        const float thr = member.threshold(bm);
        uint32_t w = 0u;
        const int r_lo = max(lo - 32 * h, 0), r_hi = min(hi - 32 * h, 32);
        for (int r = r_lo; r < r_hi; ++r) {
          const float* p = pc_s + 3 * (32 * h + r);
          const float d2 = cofii2p::membership_d2(qc, p[0], p[1], p[2]);
          if (member.member(d2, a.r2, thr)) w |= 1u << r;
        }
        bits[2 * (t * tile + q - mseg) + h] = w;
      }
      __syncthreads();
      for (int q0 = 0; q0 < tile; q0 += kTrThreads) {
        const int q = q0 + tid, jq = t * tile + q - mseg;
        const bool keep = q < tile && (bits[2 * jq] | bits[2 * jq + 1]) != 0u;
        n_list = cofii2p::append_rows(keep, jq, list, n_list, warp_tot, lane, warp);
      }
    }
    const int n_chunks = (n_list + P::RB - 1) / P::RB;
    if (n_chunks == 0) continue;
    const long grow0 = ((long)b * a.M + mseg) * KC + c0;  // the segment's first g row, channel c0

    for (int k = 0; k < a.K; ++k) {
      const float kx = a.kp[k * 3], ky = a.kp[k * 3 + 1], kz = a.kp[k * 3 + 2];
      // the positions of listed queries [c * RB, c * RB + RB) and their g
      // rows at kernel point k (fp32 kept, or rounded to bf16) into a slot
      auto load_chunk = [&](int c, int slot) {
        const int a0 = c * P::RB;
        for (int i = tid; i < P::RB * 3; i += kTrThreads) {
          const int r = a0 + i / 3;
          pq_s[slot * P::RB * 3 + i] = r < n_list ? a.q[((long)b * a.M + mseg + list[r]) * 3 + i % 3] : 0.f;
        }
        cofii2p::stage_rows<P, CB>(F_s + slot * P::RB * P::F_STRIDE, a.g, 0, g_vec, ncols, KC,
                                   grow0 + (long)k * a.C, list, a0, n_list, tid);
      };

      load_chunk(0, 0);
      __syncthreads();  // chunk 0's positions
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c & 1;
        if (c + 1 < n_chunks) load_chunk(c + 1, slot ^ 1);
        // influence of kernel point k for (row, chunk query) where the bit
        // is set: a thread keeps one chunk query, its word and its
        // position, and takes every (kTrThreads / RB)-th row
        const int r = tid % P::RB;
        const int a0 = c * P::RB;
        uint64_t word = 0u;
        if (a0 + r < n_list) {
          const int jq = list[a0 + r];
          word = (uint64_t)bits[2 * jq] | ((uint64_t)bits[2 * jq + 1] << 32);
        }
        const float* pq = pq_s + (slot * P::RB + r) * 3;
        const float qx = pq[0], qy = pq[1], qz = pq[2];
#pragma unroll 4
        for (int s = tid / P::RB; s < P::TS; s += kTrThreads / P::RB) {
          float v = 0.f;
          if ((word >> s) & 1u) {
            const float* sp = sp_s + 3 * s;
            // (s - q) - kp, as the forward kernels take it
            const float dx = (sp[0] - qx) - kx;
            const float dy = (sp[1] - qy) - ky;
            const float dz = (sp[2] - qz) - kz;
            const float d2 = dx * dx + dy * dy + dz * dz;
            v = d2 > 0.f ? fmaxf(1.f - d2 * rsqrtf(d2) * inv_sigma, 0.f) : 1.f;
          }
          if constexpr (F32)
            cofii2p::split_tf32(v, A_hi[s * P::A_STRIDE + r], A_lo[s * P::A_STRIDE + r]);
          else
            A_s[s * P::A_STRIDE + r] = __float2bfloat16(v);
        }
        if (c + 1 < n_chunks)
          cofii2p::cp_async_wait<1>();
        else
          cofii2p::cp_async_wait<0>();
        __syncthreads();

        // sums (TS, CB) += infl (TS, RB) @ g_k (RB, CB)
        const E* Fs = F_s + slot * P::RB * P::F_STRIDE;
        if constexpr (F32)
          cofii2p::aggregate_tf32x3<P>(acc, A_hi, A_lo, Fs, wm, wn, g, t4);
        else
          cofii2p::aggregate_bf16<P>(acc, A_s, Fs, wm, wn, lane);
        __syncthreads();  // the next chunk's influence and load reuse A_s and this slot
      }
    }
  }

  // the sums to out[b, s0 + row, c0 + col] (WINDOW: stack[b, t, row0 +
  // row, c0 + col]): every element of the block's (TS, ncols) range once,
  // zero where no pair reached the row
  const long orow0 = WINDOW ? ((long)b * a.num_tiles + t_first) * a.band + row0 : (long)b * a.N + s0;
  const bool pairs = (a.C & 1) == 0;
#pragma unroll
  for (int i = 0; i < P::MA; ++i) {
#pragma unroll
    for (int jn = 0; jn < P::NA; ++jn) {
      const int col = (wn * P::NA + jn) * 8 + 2 * t4;
      if (col >= ncols) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (wm * P::MA + i) * 16 + g + 8 * half;
        if (row >= TS) continue;
        float* dst = a.out + (orow0 + row) * a.C + c0 + col;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[i][jn][2 * half], acc[i][jn][2 * half + 1]);
        } else {
          dst[0] = acc[i][jn][2 * half];
          if (col + 1 < ncols) dst[1] = acc[i][jn][2 * half + 1];
        }
      }
    }
  }
}

template <int CB, bool F32, bool WINDOW, class Member>
int launch_transpose_mma(const cofii2p::TransposeArgs& a, const Member& member) {
  using P = cofii2p::TransposePlan<CB, F32>;
  auto kern = kpconv_transpose_mma_kernel<CB, F32, WINDOW, Member>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = WINDOW ? a.num_tiles * (a.band / a.TS) : a.N / a.TS;
  kern<<<dim3(blocks, a.B, (a.C + CB - 1) / CB), kTrThreads, P::SMEM, a.st>>>(a, member);
  return static_cast<int>(cudaGetLastError());
}

// The built kernel for a's channel range (every CB of
// COFII2P_TRANSPOSE_WIDTHS); shapes the plan does not take are refused
// before anything runs.  WINDOW: TS divides the window width band <= N,
// so that a block's rows stay inside its window, which lies in [0, N) for
// starts in [0, N - band] (ops/banded.py::dynamic_band_starts clips them).
template <bool F32, bool WINDOW, class Member>
int launch_transpose_widths(const cofii2p::TransposeArgs& a, const Member& member) {
  const int rows = WINDOW ? a.band : a.N;
  if (a.C < 1 || a.C > cofii2p::kMmaMaxC || a.TS < 1 || a.TS > cofii2p::TransposePlan<32, F32>::TS || rows % a.TS ||
      a.tile < 1 || a.tile > 128 || a.M % a.tile || a.M / a.tile != a.num_tiles || a.band < 1 || a.band > a.N ||
      a.n_qtiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cb = cofii2p::transpose_cb(a.C);
#define COFII2P_TRANSPOSE_LAUNCH(cb_) \
  if (cb == cb_) return launch_transpose_mma<cb_, F32, WINDOW>(a, member);
  COFII2P_TRANSPOSE_WIDTHS(COFII2P_TRANSPOSE_LAUNCH)
#undef COFII2P_TRANSPOSE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
