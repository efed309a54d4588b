// The forward band max for Hopper (the strided blocks' shortcut): kernels
// #3 and #8, and in COUNT mode the tie count of their backward, #12.
//
// Replaces: cofii2p_tpu/ops/maxpool_kernel.py::banded_maxpool_pallas (body
// _maxpool_kernel, kernel #3): out[m, c] = max of f[j, c] over the band
// rows j of m's 128-query tile with d2 <= r2, 0 where there is none; and
// maxpool_kernel.py::banded_maxpool_tau_pallas (body _maxpool_kernel_tau,
// kernel #8), the reference's k-NN maxpool, with d2 <= tau[m], each
// query's threshold from kernel #5, in place of the shared radius.  out
// keeps the feature dtype; either takes static bands or dynamic window
// starts.  COUNT replaces maxpool_kernel.py::_match_count (body
// _count_kernel, kernel #12): cnt[m, c] = the number of those member rows
// with f[j, c] == out[m, c], out the forward's output, compared in fp32
// (bf16 widened exactly: +0 == -0), fp32 counts, 0 where there is no
// member; by radius or by tau, on static bands or windows.
//
// What bounds it on the H100: reading member rows.  A query holds ~128 band
// rows (k-NN) or its radius ball, so the max reads each feature element
// once per query that holds its row: ~43x the bytes the call must move.
// The design keeps those reads on chip and cheap (plan in maxpool_plan.cuh):
//  - one block per 128-query tile and every channel, so membership is
//    tested once a tile: each band row against all 128 queries, its bits
//    kept in shared memory;
//  - only the rows some query holds are listed, and their features are
//    staged from global memory once per (tile, channel slice), 32 rows a
//    chunk by cp.async, double-buffered;
//  - a warp keeps the running maxima of 8 queries in registers and walks
//    each query's membership word of a chunk, four member rows at a time
//    (independent shared loads), a lane taking 16 bytes of channels: fp32
//    fmaxf, bf16 two channels a word by __hmax2.
// COUNT keeps all of that and changes the operation on a member: a warp
// reads its queries' out slice once a slice into registers, and each
// staged member value equal to it adds one to the lane's count of that
// channel (two 16-bit counts a word); the walk's repeats of the last
// member past the end, harmless to a max, are masked.
//
// Exactness: it is a select, so the result is bit-equal to the plain
// version in fp32 and in bf16, and each query's members are maxed in band
// order; counts are integers, equal in any order.  Membership d2 uses the
// centred, FMA-free arithmetic of the other banded kernels (common.cuh),
// centred on the tile's first query, so the tie count counts over exactly
// the rows the forward maxed over.

#include "maxpool_plan.cuh"
#include "mma.cuh"

namespace {

using cofii2p::PoolPlan;

template <bool BF16>
__device__ __forceinline__ unsigned max_word(unsigned a, unsigned b) {
  if constexpr (BF16) {
    const __nv_bfloat162 m =
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a), *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const unsigned*>(&m);
  } else {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
}

// A lane's 16 bytes of channels, maxed channel by channel
template <bool BF16>
__device__ __forceinline__ uint4 max_words(uint4 a, uint4 b) {
  return make_uint4(max_word<BF16>(a.x, b.x), max_word<BF16>(a.y, b.y), max_word<BF16>(a.z, b.z),
                    max_word<BF16>(a.w, b.w));
}

// COUNT: a lane's LW words of a staged row or of out
template <int LW>
__device__ __forceinline__ void load_lane(const unsigned char* p, unsigned (&w)[LW]) {
  if constexpr (LW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  }
}

// COUNT: the ties of channel pair k of a lane's 4 channels, as a count
// word (channel 2k in the low 16 bits): fp32 words 2k and 2k + 1 compared
// as floats, bf16 word k's halves widened to fp32 (exact) and compared
template <bool BF16, int LW>
__device__ __forceinline__ unsigned tie_pair(const unsigned (&v)[LW], const unsigned (&o)[LW], int k) {
  if constexpr (BF16) {
    return (__uint_as_float(v[k] << 16) == __uint_as_float(o[k] << 16) ? 1u : 0u) |
           (__uint_as_float(v[k] & 0xffff0000u) == __uint_as_float(o[k] & 0xffff0000u) ? 0x10000u : 0u);
  } else {
    return (__uint_as_float(v[2 * k]) == __uint_as_float(o[2 * k]) ? 1u : 0u) |
           (__uint_as_float(v[2 * k + 1]) == __uint_as_float(o[2 * k + 1]) ? 0x10000u : 0u);
  }
}

// Segment [seg0, seg1) of the band: each row tested against every query of
// the tile once; the rows any query holds listed in band order (list_s,
// relative to seg0) with their 128 query bits (rowbits_s), then those
// transposed into qbits_s[q * QB_STRIDE + w], bit k: listed row 32 w + k is
// in query q's neighbourhood.  Every thread calls it; returns the list's
// length.
template <class P>
__device__ int build_membership(const float4* q_s, const float* srow, float rx, float ry, float rz, int seg0,
                                int seg1, unsigned short* list_s, uint4* rowbits_s, unsigned* qbits_s, int* cnt_s,
                                int nq, int tid, int lane, int warp) {
  int base = 0;
  for (int r0 = seg0; r0 < seg1; r0 += P::THREADS) {
    const int j = r0 + tid;
    unsigned rm[4] = {0u, 0u, 0u, 0u};
    if (j < seg1) {
      const float px = __fsub_rn(srow[j * 3], rx);
      const float py = __fsub_rn(srow[j * 3 + 1], ry);
      const float pz = __fsub_rn(srow[j * 3 + 2], rz);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned bits = 0u;
        const int kn = min(32, nq - 32 * w);
        for (int k = 0; k < kn; ++k) {
          const float4 qq = q_s[32 * w + k];
          const float qc[3] = {qq.x, qq.y, qq.z};
          bits |= (cofii2p::membership_d2(qc, px, py, pz) <= qq.w ? 1u : 0u) << k;
        }
        rm[w] = bits;
      }
    }
    const bool held = (rm[0] | rm[1] | rm[2] | rm[3]) != 0u;
    const unsigned flags = __ballot_sync(0xffffffffu, held);
    if (lane == 0) cnt_s[warp] = __popc(flags);
    __syncthreads();
    int off = base, total = 0;
#pragma unroll
    for (int w = 0; w < P::WARPS; ++w) {
      if (w < warp) off += cnt_s[w];
      total += cnt_s[w];
    }
    if (held) {
      const int p = off + __popc(flags & ((1u << lane) - 1u));
      list_s[p] = static_cast<unsigned short>(j - seg0);
      rowbits_s[p] = make_uint4(rm[0], rm[1], rm[2], rm[3]);
    }
    base += total;
    __syncthreads();
  }
  // transpose: lane k of a warp ends with query 32 qw + k's word of 32
  // listed rows
  const int nwords = (base + 31) / 32;
  for (int w = warp; w < nwords; w += P::WARPS) {
    const int p = 32 * w + lane;
    const uint4 r = p < base ? rowbits_s[p] : make_uint4(0u, 0u, 0u, 0u);
    const unsigned rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int qw = 0; qw < 4; ++qw) {
      unsigned mine = 0u;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const unsigned word = __ballot_sync(0xffffffffu, (rw[qw] >> k) & 1u);
        if (lane == k) mine = word;
      }
      qbits_s[(32 * qw + lane) * P::QB_STRIDE + w] = mine;
    }
  }
  __syncthreads();
  return base;
}

// Listed rows [32 k, 32 k + 32) of the segment, channels [c0, c0 + CS),
// into slot dst: one cp.async group.  vec: whole 16-byte pieces (C a
// multiple of 16 / ESZ, f aligned); otherwise element by element.
template <class P, int ESZ>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const unsigned char* f, bool vec, long frow0, int C,
                                            int c0, int seg0, const unsigned short* list_s, int k, int n_list,
                                            int tid) {
  constexpr int kElems = 16 / ESZ;
  for (int i = tid; i < P::RB * P::PIECES; i += P::THREADS) {
    const int r = i / P::PIECES, c = c0 + (i % P::PIECES) * kElems;
    const int p = P::RB * k + r;
    if (p >= n_list || c >= C) continue;
    const long e = frow0 + (long)(seg0 + list_s[p]) * C + c;
    unsigned char* d = dst + r * P::ROW_BYTES + (i % P::PIECES) * 16;
    if (vec) {
      cofii2p::cp_async16(d, f + e * ESZ, 16);
    } else {
      for (int x = 0; x < kElems && c + x < C; ++x)
        for (int y = 0; y < ESZ; ++y) d[x * ESZ + y] = f[(e + x) * ESZ + y];
    }
  }
  cofii2p::cp_async_commit();
}

// grid (num_tiles, B); P's threads and shared memory.  tau (B, M) or null
// (then the threshold is r2 for every query); nseg membership segments of
// the band, nslice channel slices (the plan's pool_segments, pool_slices).
// COUNT: out is read (the forward's output) and the counts go to cnt.
template <bool BF16, bool COUNT>
__global__ void __launch_bounds__(cofii2p::kPoolThreads, 512 / cofii2p::kPoolThreads) maxpool_fwd_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts, const void* __restrict__ feats,
    const int* __restrict__ starts, const float* __restrict__ tau, float r2, void* __restrict__ out,
    float* __restrict__ cnt, int M, int N, int C, int tile, int band, int nseg, int nslice, int vec) {
  constexpr int ESZ = BF16 ? 2 : 4;
  using P = PoolPlan<ESZ, COUNT>;
  constexpr unsigned kNegInf = BF16 ? 0xff80ff80u : 0xff800000u;  // -inf in every channel of a word
  extern __shared__ __align__(16) unsigned char smem[];
  float4* q_s = reinterpret_cast<float4*>(smem);
  unsigned* qbits_s = reinterpret_cast<unsigned*>(smem + P::Q_BYTES);
  unsigned char* union_s = smem + P::Q_BYTES + P::QBITS_BYTES;  // row bits, then the staged chunks
  unsigned short* list_s = reinterpret_cast<unsigned short*>(union_s + P::UNION_BYTES);
  int* cnt_s = reinterpret_cast<int*>(union_s + P::UNION_BYTES + P::LIST_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, b = blockIdx.y;
  const int num_tiles = M / tile;
  const int m0 = t * tile;
  const int start = starts[b * num_tiles + t];
  const float* ref_p = q_pts + ((long)b * M + m0) * 3;
  const float rx = ref_p[0], ry = ref_p[1], rz = ref_p[2];
  const float* srow = s_pts + ((long)b * N + start) * 3;
  const long frow0 = ((long)b * N + start) * C;
  const unsigned char* f = static_cast<const unsigned char*>(feats);

  if (tid < P::TQ) {
    // a query past the tile is no one's: its threshold is -inf
    float4 v = make_float4(0.f, 0.f, 0.f, -INFINITY);
    if (tid < tile) {
      const float* qp = q_pts + ((long)b * M + m0 + tid) * 3;
      v = make_float4(__fsub_rn(qp[0], rx), __fsub_rn(qp[1], ry), __fsub_rn(qp[2], rz),
                      tau ? tau[(long)b * M + m0 + tid] : r2);
    }
    q_s[tid] = v;
  }
  __syncthreads();

  int n_list = 0;
  for (int sl = 0; sl < nslice; ++sl) {
    const int c0 = sl * P::CS;
    uint4 acc[P::QPW];
#pragma unroll
    for (int i = 0; i < P::QPW; ++i) acc[i] = make_uint4(kNegInf, kNegInf, kNegInf, kNegInf);
    unsigned has = 0u;  // bit i: the warp's query i holds a row
    // COUNT: the warp's queries' out slice and their tie counts
    unsigned ov[COUNT ? P::QPW : 1][P::LANE_WORDS], ties[COUNT ? P::QPW : 1][COUNT ? P::CNT_WORDS : 1];
    if constexpr (COUNT) {
      const int c = c0 + lane * P::VEC;
#pragma unroll
      for (int i = 0; i < P::QPW; ++i) {
        const int q = i * P::WARPS + warp;
#pragma unroll
        for (int k = 0; k < P::CNT_WORDS; ++k) ties[i][k] = 0u;
#pragma unroll
        for (int w = 0; w < P::LANE_WORDS; ++w) ov[i][w] = 0u;
        if (q >= tile || c >= C) continue;
        const unsigned char* o = static_cast<const unsigned char*>(out) + (((long)b * M + m0 + q) * C + c) * ESZ;
        if (vec) {
          load_lane<P::LANE_WORDS>(o, ov[i]);
        } else {
          // element by element; the channels past C stay 0 (their counts are not written)
#pragma unroll
          for (int x = 0; x < P::VEC; ++x) {
            if (c + x >= C) break;
            if constexpr (BF16)
              ov[i][x / 2] |= static_cast<unsigned>(reinterpret_cast<const unsigned short*>(o)[x]) << (16 * (x & 1));
            else
              ov[i][x] = reinterpret_cast<const unsigned*>(o)[x];
          }
        }
      }
    }
    for (int sg = 0; sg < nseg; ++sg) {
      const int seg0 = sg * P::SEG, seg1 = min(band, seg0 + P::SEG);
      if (nseg > 1 || sl == 0) {
        __syncthreads();  // the previous walk is done with the list and the staged chunks
        n_list = build_membership<P>(q_s, srow, rx, ry, rz, seg0, seg1, list_s,
                                     reinterpret_cast<uint4*>(union_s), qbits_s, cnt_s, min(tile, P::TQ), tid, lane,
                                     warp);
      }
      const int nchunks = (n_list + P::RB - 1) / P::RB;
      if (nchunks) stage_chunk<P, ESZ>(union_s, f, vec, frow0, C, c0, seg0, list_s, 0, n_list, tid);
      for (int k = 0; k < nchunks; ++k) {
        if (k + 1 < nchunks) {
          stage_chunk<P, ESZ>(union_s + ((k + 1) & 1) * P::RB * P::ROW_BYTES, f, vec, frow0, C, c0, seg0, list_s,
                              k + 1, n_list, tid);
          cofii2p::cp_async_wait<1>();
        } else {
          cofii2p::cp_async_wait<0>();
        }
        __syncthreads();
        const unsigned char* buf = union_s + (k & 1) * P::RB * P::ROW_BYTES + lane * P::LANE_BYTES;
        if constexpr (COUNT) {
#pragma unroll
          for (int i = 0; i < P::QPW; ++i) {
            unsigned bits = qbits_s[(i * P::WARPS + warp) * P::QB_STRIDE + k];
            while (bits) {
              // kPoolWalk member rows a step, as the max walks them; the
              // repeats of the last member past the end are not counted
              int p[cofii2p::kPoolWalk];
              unsigned live = 0u;
#pragma unroll
              for (int u = 0; u < cofii2p::kPoolWalk; ++u) {
                const bool next = u == 0 || bits;
                live |= (next ? 1u : 0u) << u;
                p[u] = next ? __ffs(bits) - 1 : p[u == 0 ? 0 : u - 1];
                bits &= bits - 1u;
              }
              unsigned v[cofii2p::kPoolWalk][P::LANE_WORDS];
#pragma unroll
              for (int u = 0; u < cofii2p::kPoolWalk; ++u) load_lane<P::LANE_WORDS>(buf + p[u] * P::ROW_BYTES, v[u]);
#pragma unroll
              for (int u = 0; u < cofii2p::kPoolWalk; ++u)
#pragma unroll
                for (int kk = 0; kk < P::CNT_WORDS; ++kk)
                  ties[i][kk] += (live >> u) & 1u ? tie_pair<BF16, P::LANE_WORDS>(v[u], ov[i], kk) : 0u;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < P::QPW; ++i) {
            unsigned bits = qbits_s[(i * P::WARPS + warp) * P::QB_STRIDE + k];
            has |= (bits != 0u ? 1u : 0u) << i;
            while (bits) {
              // kPoolWalk member rows a step, independent loads, maxed in
              // band order; past the last member the last one is read again
              // (the max is idempotent)
              int p[cofii2p::kPoolWalk];
#pragma unroll
              for (int u = 0; u < cofii2p::kPoolWalk; ++u) {
                p[u] = u == 0 || bits ? __ffs(bits) - 1 : p[u == 0 ? 0 : u - 1];
                bits &= bits - 1u;
              }
              uint4 v[cofii2p::kPoolWalk];
#pragma unroll
              for (int u = 0; u < cofii2p::kPoolWalk; ++u)
                v[u] = *reinterpret_cast<const uint4*>(buf + p[u] * P::ROW_BYTES);
#pragma unroll
              for (int u = 0; u < cofii2p::kPoolWalk; ++u) acc[i] = max_words<BF16>(acc[i], v[u]);
            }
          }
        }
        __syncthreads();  // every warp is done with slot k & 1 before chunk k + 2 lands there
      }
    }
    const int c = c0 + lane * P::VEC;
    if constexpr (COUNT) {
      // the slice's counts, fp32; 0 where a query holds no row
#pragma unroll
      for (int i = 0; i < P::QPW; ++i) {
        const int q = i * P::WARPS + warp;
        if (q >= tile || c >= C) continue;
        float n[P::VEC];
#pragma unroll
        for (int kk = 0; kk < P::CNT_WORDS; ++kk) {
          n[2 * kk] = static_cast<float>(ties[i][kk] & 0xffffu);
          n[2 * kk + 1] = static_cast<float>(ties[i][kk] >> 16);
        }
        float* o = cnt + ((long)b * M + m0 + q) * C + c;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(n[0], n[1], n[2], n[3]);
        } else {
#pragma unroll
          for (int x = 0; x < P::VEC; ++x)
            if (c + x < C) o[x] = n[x];
        }
      }
      continue;
    }
    // the slice's maxima; 0 (all bits clear, in both dtypes) where a query
    // holds no row
#pragma unroll
    for (int i = 0; i < P::QPW; ++i) {
      const int q = i * P::WARPS + warp;
      if (q >= tile || c >= C) continue;
      const uint4 v = (has >> i) & 1u ? acc[i] : make_uint4(0u, 0u, 0u, 0u);
      unsigned char* o = static_cast<unsigned char*>(out) + (((long)b * M + m0 + q) * C + c) * ESZ;
      if (vec) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(&v);
        for (int x = 0; x < P::VEC && c + x < C; ++x)
          for (int y = 0; y < ESZ; ++y) o[x * ESZ + y] = src[x * ESZ + y];
      }
    }
  }
}

template <bool BF16, bool COUNT>
int launch(const void* q, const void* s, const void* f, const void* starts, const float* tau, float r2, void* out,
           float* cnt, int B, int M, int N, int C, int tile, int band, cudaStream_t stream) {
  using P = PoolPlan<BF16 ? 2 : 4, COUNT>;
  auto kern = maxpool_fwd_kernel<BF16, COUNT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int esz = BF16 ? 2 : 4;
  const int vec = C % (16 / esz) == 0 && (reinterpret_cast<uintptr_t>(f) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0 && (reinterpret_cast<uintptr_t>(cnt) & 15) == 0;
  dim3 grid(M / tile, B);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(static_cast<const float*>(q), static_cast<const float*>(s), f,
                                              static_cast<const int*>(starts), tau, r2, out, cnt, M, N, C, tile,
                                              band, cofii2p::pool_segments(band), cofii2p::pool_slices(C, P::CS),
                                              vec);
  return static_cast<int>(cudaGetLastError());
}

// The forward (cnt null) or, with cnt, the tie count over out
int launch_pool(const void* q, const void* s, const void* f, int f_bf16, const void* starts, const float* tau,
                float r2, void* out, float* cnt, int B, int M, int N, int C, int tile, int band, void* stream) {
  if (tile < 1 || tile > cofii2p::kPoolTile || M % tile || band < 1 || band > N || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cnt) {
    if (f_bf16) return launch<true, true>(q, s, f, starts, tau, r2, out, cnt, B, M, N, C, tile, band, st);
    return launch<false, true>(q, s, f, starts, tau, r2, out, cnt, B, M, N, C, tile, band, st);
  }
  if (f_bf16) return launch<true, false>(q, s, f, starts, tau, r2, out, nullptr, B, M, N, C, tile, band, st);
  return launch<false, false>(q, s, f, starts, tau, r2, out, nullptr, B, M, N, C, tile, band, st);
}

}  // namespace

// Kernel #3.  q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, C) fp32 or bf16,
// starts (B, M / tile) int32 static band starts or window starts of width
// band; out (B, M, C) in f's dtype.  Members: d2 <= r2.  A tile over 128
// queries or a band over N is refused before anything runs.
extern "C" int maxpool_launch(const void* q, const void* s, const void* f, int f_bf16, const void* starts, void* out,
                              int B, int M, int N, int C, int tile, int band, float r2, void* stream) {
  return launch_pool(q, s, f, f_bf16, starts, nullptr, r2, out, nullptr, B, M, N, C, tile, band, stream);
}

// Kernel #8: as maxpool_launch with the members d2 <= tau[m], tau (B, M)
// fp32 the per-query squared thresholds.
extern "C" int maxpool_tau_launch(const void* q, const void* s, const void* f, int f_bf16, const void* starts,
                                  const void* tau, void* out, int B, int M, int N, int C, int tile, int band,
                                  void* stream) {
  return launch_pool(q, s, f, f_bf16, starts, static_cast<const float*>(tau), 0.f, out, nullptr, B, M, N, C, tile,
                     band, stream);
}

// Kernel #12: the tie count over the forward's output pooled (B, M, C) in
// f's dtype, members as maxpool_launch's; cnt (B, M, C) fp32.
extern "C" int maxpool_count_launch(const void* q, const void* s, const void* f, int f_bf16, const void* starts,
                                    const void* pooled, void* cnt, int B, int M, int N, int C, int tile, int band,
                                    float r2, void* stream) {
  return launch_pool(q, s, f, f_bf16, starts, nullptr, r2, const_cast<void*>(pooled), static_cast<float*>(cnt), B,
                     M, N, C, tile, band, stream);
}

// Kernel #12 under k-NN semantics: as maxpool_count_launch with the
// members d2 <= tau[m], tau (B, M) fp32.
extern "C" int maxpool_count_tau_launch(const void* q, const void* s, const void* f, int f_bf16, const void* starts,
                                        const void* tau, const void* pooled, void* cnt, int B, int M, int N, int C,
                                        int tile, int band, void* stream) {
  return launch_pool(q, s, f, f_bf16, starts, static_cast<const float*>(tau), 0.f, const_cast<void*>(pooled),
                     static_cast<float*>(cnt), B, M, N, C, tile, band, stream);
}
