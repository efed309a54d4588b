// Banded KPConv on the tensor cores: kernel #1, and #16's conv half in POOL
// mode, for every call, bf16 compute and fp32 (by 3xTF32).
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::banded_kpconv_fused_pallas
// (body _agg_fused_kernel).  For each query m,
//   out[m, :] = sum_k ( sum_j infl_k(q_m, s_j) f_j ) @ W_k,
//   count[m]  = max(#in-reach band rows, 1),
// over the band rows j of m's 128-query tile within kernel reach; out is
// fp32 and unnormalised, the caller divides by count and adds the bias.
//
// What bounds it on the H100: at the deep levels (Cin = Cout = 256, 512) the
// two products, 2 * TQ * rows * Cin and 2 * TQ * Cin * Cout multiply-adds
// per kernel point and block; at the shallow levels the influence math over
// the band.  The TPU kernel kept a (tile, 15 * Cin) fp32 accumulator in
// VMEM, 3.9 MB at Cin = 512, far beyond a block's 227 KB of shared memory,
// so here the kernel point k is the outer loop and both products run on
// the tensor cores (mma.sync, fp32 accumulate):
//  - aggregation: for kernel point k and a chunk of RB active rows, the
//    (TQ, RB) influence tile is computed in fp32 and staged in shared
//    memory as the A operand; the rows' features are the B operand, staged
//    by 16-byte cp.async, double buffered, the next chunk in flight while
//    this one's influence is computed; acc_k (TQ, Cin) accumulates in fp32
//    fragments;
//  - contraction: acc_k is parked in shared memory (A) and out (TQ, Cout)
//    += acc_k @ W_k accumulates in fp32 fragments across the 15 kernel
//    points, W read from L2 in the fragment layout the wrapper ships, so
//    one load is a lane's B fragments.
// bf16 (m16n8k16) at the TPU kernel's rounding points (its jnp.dot(infl, f)
// and jnp.dot(acc.astype(cdtype), w) with fp32 results): influence and
// features rounded to bf16 before their product (features through
// ldmatrix.trans), acc_k rounded before the contraction, W arriving as
// ops/kpconv_kernel.py::mma_weights' bf16.  fp32 (F32) by 3xTF32
// (m16n8k8): each operand split into tf32 hi + lo (cvt.rna), the influence
// once where it is computed, the features, acc_k and W
// (ops/kpconv_kernel.py::tf32_weights' fp32) at their fragment loads; lo*hi
// + hi*lo + hi*hi of each 8-deep k-step summed from zero and added to the
// fp32 accumulator with round-to-nearest (cofii2p::mma_tf32x3), about
// 2^-21 relative against the 1e-3 gate that one TF32 product's 2^-11 would
// strain.  The row list, the chunk loader and both products in both
// precisions are mma.cuh's, shared with the k-NN (tau) kernel of
// kpconv_tau_mma.cuh (#7, #6, and #2 under radius membership).  A
// zero-influence pair costs a bit test and a zero, so a block takes 64
// queries (32 at 512 channels, MmaPlan); at narrow widths two blocks share
// an SM, so that one block's influence pass and barriers overlap the
// other's products.
//
// Membership: d2 centred on the tile's first query with the _rn intrinsics
// (cofii2p::membership_d2), as the JAX package computes it, so no FMA is
// contracted and the counts are the plain version's bit for bit; warp
// ballots kept as per-query bitmasks of a segment of P::SEG band rows
// (2048 in bf16; 3072 in fp32, every band of the FPN) with an ordered list
// of the rows any query reaches, so the influence pass tests a bit instead
// of recomputing d2 for every kernel point.  A band over one segment is
// walked segment by segment, each segment's membership redone for every
// kernel point.  The influence takes its offset from the uncentred
// coordinates, s_j - q_m, which is exact for nearby points: centred on a
// tile reference metres away (a tile can straddle a Morton jump) each
// coordinate rounds at the reference's scale, ~4e-6 m at 32 m, an
// influence error of ~2e-5.  Only the order of the fp32 sums differs from
// the plain version's.
//
// POOL (kernel #16, csrc/residual_fused.cu): the strided ResidualBlock's
// shortcut maxpool rides on the membership pass.  Once the first kernel
// point's pass has a segment's bitmasks, the block walks each query's set
// bits over the block-input features (Cmp channels; a thread takes 4
// adjacent channels of one query in one 8- or 16-byte load per member row,
// coalesced over channels, four member rows in flight) for the max, before
// the aggregation.  Band rows are thus tested once for both halves; the
// conv half is this kernel unchanged at the same plan, so its sums and
// counts are #1's bit for bit in each precision.  Over more than one
// segment the running max is kept in the output, read back by the thread
// that wrote it.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kpconv_mma_plan.cuh"
#include "mma.cuh"

namespace cofii2p {

// One launch of #1 (mp_feats null) or #16 (POOL: mp_feats (B, N, Cmp) in
// its own dtype, mp_out (B, M, Cmp) in the same).  W in the fragment
// layout of the compute dtype: bf16 mma_weights', fp32 tf32_weights'.
struct FusedArgs {
  const float* q;
  const float* s;
  const void* f;
  int f_bf16;
  const void* W;
  const float* kp;
  const int* starts;
  float* out;
  int* count;
  int B, M, N, Cin, Cout, K, tile, num_tiles, band;
  float r2, sigma;
  cudaStream_t st;
  const void* mp_feats;
  int mp_bf16, Cmp;
  void* mp_out;
};

int fused_launch_f32(const FusedArgs& a);     // kpconv_fused_f32.cu: #1 in fp32
int residual_launch_f32(const FusedArgs& a);  // residual_fused_f32.cu: #16 in fp32

}  // namespace cofii2p

namespace {

using cofii2p::MmaPlan;
constexpr int kThreads = cofii2p::kMmaThreads;

// V channels of f from element idx (V = 4: one 8- or 16-byte load, idx a
// multiple of 4 and the pointer 16-byte aligned), as fp32.
template <int V>
__device__ __forceinline__ void load_v(const void* p, long idx, int is_bf16, float* v) {
  if constexpr (V == 4) {
    if (is_bf16) {
      const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + idx);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + idx);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    }
  } else {
    v[0] = cofii2p::load_f(p, idx, is_bf16);
  }
}

template <int V>
__device__ __forceinline__ void store_v(void* p, long idx, int is_bf16, const float* v) {
  if constexpr (V == 4) {
    if (is_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 raw;
      raw.x = *reinterpret_cast<const unsigned*>(&lo);
      raw.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + idx) = raw;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p) + idx) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else if (is_bf16) {
    static_cast<__nv_bfloat16*>(p)[idx] = __float2bfloat16(v[0]);
  } else {
    static_cast<float*>(p)[idx] = v[0];
  }
}

// POOL's max over one membership segment: (query, V channels) items spread
// over the block, each walking its query's set bits (WORDS words a query)
// in row order, four member rows' loads in flight at a time; the running
// max starts at -inf (first segment) or is read back from out, and the last
// segment writes 0 where the query has no member.  A max is exact, so the
// result equals #3's whatever the item shape.  Beside the tensor-core
// products a one-load walk waits on L2 once per member row: #16 took 7.0
// ms a bf16 serving forward against 5.3 for #1 and #3 apart, 5.6 with this
// walk (H100 80GB HBM3).
template <int V, int WORDS>
__device__ __forceinline__ void pool_segment_x4(const unsigned* mask, const void* f, int f_bf16, void* out, int C,
                                                int TQ, int nwords, bool first, bool last, const int* cnt, long frow0,
                                                long out0, int tid) {
  const int G = C / V;
  for (int idx = tid; idx < TQ * G; idx += kThreads) {
    const int q = idx / G, c = (idx - q * G) * V;
    const long o = out0 + (long)q * C + c;
    float mx[V];
    if (first) {
#pragma unroll
      for (int v = 0; v < V; ++v) mx[v] = -INFINITY;
    } else {
      load_v<V>(out, o, f_bf16, mx);
    }
    for (int w = 0; w < nwords; ++w) {
      unsigned bits = mask[q * WORDS + w];
      while (bits) {
        int rows[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          rows[u] = bits ? w * 32 + __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
        float fv[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (rows[u] >= 0) load_v<V>(f, frow0 + (long)rows[u] * C + c, f_bf16, fv[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (rows[u] < 0) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) mx[v] = fmaxf(mx[v], fv[u][v]);
        }
      }
    }
    if (last && cnt[q] == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) mx[v] = 0.f;
    }
    store_v<V>(out, o, f_bf16, mx);
  }
}

// grid (M / TQ, B), kThreads threads, MmaPlan<CI, CO, F32>::SMEM bytes of
// dynamic shared memory.  TQ (runtime) divides the band tile and is at
// most the plan's; Cin <= CI, Cout <= CO.  W (K, CO, CI) in the compute
// dtype's fragment layout (the header); feats bf16 or fp32 (in bf16
// compute rounded to bf16 on load).
template <int CI, int CO, bool POOL, bool F32>
__global__ void __launch_bounds__(kThreads, (MmaPlan<CI, CO, F32>::MIN_BLOCKS)) kpconv_mma_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const void* __restrict__ feats, int f_bf16, const void* __restrict__ W,
    const float* __restrict__ kp, const int* __restrict__ starts,
    float* __restrict__ out, int* __restrict__ count, int M, int N, int Cin,
    int Cout, int K, int tile, int num_tiles, int band, int TQ, float r2,
    float sigma, const void* __restrict__ mp_feats, int mp_bf16, int Cmp,
    void* __restrict__ mp_out) {
  using P = MmaPlan<CI, CO, F32>;
  using E = typename std::conditional<F32, float, __nv_bfloat16>::type;   // a staged operand
  using Idx = typename std::conditional<F32, unsigned short, int>::type;  // an active-row index
  constexpr int kSeg = P::SEG, kWords = P::WORDS;
  extern __shared__ __align__(16) unsigned char smem[];
  E* F_s = reinterpret_cast<E*>(smem);
  E* P_s = reinterpret_cast<E*>(smem + P::F_BYTES);
  // the influence tile: bf16, or fp32 split into tf32 hi (A_hi) and lo
  E* A_s = reinterpret_cast<E*>(smem + P::F_BYTES + P::P_BYTES);
  uint32_t* A_hi = reinterpret_cast<uint32_t*>(A_s);
  uint32_t* A_lo = A_hi + P::TQ * P::A_STRIDE;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + P::F_BYTES + P::P_BYTES + P::A_BYTES);
  Idx* act = reinterpret_cast<Idx*>(mask + P::TQ * kWords);
  float* qc_s = reinterpret_cast<float*>(act + kSeg);
  float* qa_s = qc_s + P::TQ * 3;
  int* cnt_s = reinterpret_cast<int*>(qa_s + P::TQ * 3);
  int* warp_tot = cnt_s + P::TQ;
  int* n_act_s = warp_tot + kThreads / 32;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group and column pair
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * TQ;
  const int t = m0 / tile;
  const int start = starts[b * num_tiles + t];
  const float* ref_p = q_pts + ((long)b * M + (long)t * tile) * 3;
  const float ref0 = ref_p[0], ref1 = ref_p[1], ref2 = ref_p[2];
  const float* srow = s_pts + ((long)b * N + start) * 3;
  const long frow0 = ((long)b * N + start) * Cin;

  for (int i = tid; i < P::TQ * 3; i += kThreads) {
    qa_s[i] = i < TQ * 3 ? q_pts[((long)b * M + m0) * 3 + i] : 0.f;
    qc_s[i] = __fsub_rn(qa_s[i], ref_p[i % 3]);
  }
  for (int i = tid; i < P::TQ; i += kThreads) cnt_s[i] = 0;
  __syncthreads();

  const int wma = warp / P::WNA, wna = warp % P::WNA;  // this warp's aggregate tiles
  const int wmo = warp / P::WNO, wno = warp % P::WNO;  // and output tiles
  float o[P::MO][P::NO][4];
#pragma unroll
  for (int i = 0; i < P::MO; ++i)
#pragma unroll
    for (int j = 0; j < P::NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;

  const bool f_vec = cofii2p::stage_vec<E>(feats, f_bf16, Cin);
  const bool one_seg = band <= kSeg;
  for (int k = 0; k < K; ++k) {
    const float kx = kp[k * 3], ky = kp[k * 3 + 1], kz = kp[k * 3 + 2];
    float acc[P::MA][P::NA][4];
#pragma unroll
    for (int i = 0; i < P::MA; ++i)
#pragma unroll
      for (int j = 0; j < P::NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int seg0 = 0; seg0 < band; seg0 += kSeg) {
      const int seg1 = min(band, seg0 + kSeg);
      if (k == 0 || !one_seg) {
        // ordered list of segment rows with at least one in-reach query,
        // and each query's membership bits; the first pass also counts
        // in-reach rows per query
        int base = 0;
        for (int r0 = seg0; r0 < seg1; r0 += kThreads) {
          const int j = r0 + tid;
          const bool valid = j < seg1;
          float px = 0.f, py = 0.f, pz = 0.f;
          if (valid) {
            px = __fsub_rn(srow[j * 3], ref0);
            py = __fsub_rn(srow[j * 3 + 1], ref1);
            pz = __fsub_rn(srow[j * 3 + 2], ref2);
          }
          bool any = false;
          for (int q = 0; q < TQ; ++q) {
            const float d2 = cofii2p::membership_d2(qc_s + 3 * q, px, py, pz);
            const bool in = valid && d2 <= r2;
            any |= in;
            const unsigned bits = __ballot_sync(0xffffffffu, in);
            if (lane == 0) {
              mask[q * kWords + (r0 - seg0) / 32 + warp] = bits;
              if (k == 0 && bits) atomicAdd(&cnt_s[q], __popc(bits));
            }
          }
          base = cofii2p::append_rows(any, j - seg0, act, base, warp_tot, lane, warp);
        }
        if (tid == 0) *n_act_s = base;
        __syncthreads();
        if constexpr (POOL) {
          if (k == 0) {
            // the shortcut over this segment's members; cnt_s is complete
            // once the last segment's ballots are in
            const int nwords = (seg1 - seg0 + 31) / 32;
            const long mrow0 = ((long)b * N + start + seg0) * Cmp;
            const long out0 = ((long)b * M + m0) * Cmp;
            const bool vec = (Cmp & 3) == 0 &&
                             ((reinterpret_cast<unsigned long long>(mp_feats) |
                               reinterpret_cast<unsigned long long>(mp_out)) & 15) == 0;
            if (vec)
              pool_segment_x4<4, kWords>(mask, mp_feats, mp_bf16, mp_out, Cmp, TQ, nwords, seg0 == 0, seg1 == band,
                                         cnt_s, mrow0, out0, tid);
            else
              pool_segment_x4<1, kWords>(mask, mp_feats, mp_bf16, mp_out, Cmp, TQ, nwords, seg0 == 0, seg1 == band,
                                         cnt_s, mrow0, out0, tid);
            __syncthreads();
          }
        }
      }
      const int n_act = *n_act_s;
      const int n_chunks = (n_act + P::RB - 1) / P::RB;

      // the features of active rows [c * RB, c * RB + RB) into a slot (bf16:
      // rounded), zero past the list and past Cin
      auto load_chunk = [&](int c, int slot) {
        cofii2p::stage_rows<P, CI>(F_s + slot * P::RB * P::F_STRIDE, feats, f_bf16, f_vec, Cin, Cin,
                                   frow0 + (long)seg0 * Cin, act, c * P::RB, n_act, tid);
      };

      if (n_chunks > 0) load_chunk(0, 0);
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c & 1;
        if (c + 1 < n_chunks) load_chunk(c + 1, slot ^ 1);
        // influence of kernel point k for (query, chunk row): bf16 rounded,
        // or fp32 split into tf32 hi and lo
        const int a0 = c * P::RB;
        for (int idx = tid; idx < P::TQ * P::RB; idx += kThreads) {
          const int q = idx / P::RB, r = idx % P::RB;
          float v = 0.f;
          if (q < TQ && a0 + r < n_act) {
            const int j = act[a0 + r];
            if ((mask[q * kWords + (j >> 5)] >> (j & 31)) & 1u) {
              const float* qa = qa_s + 3 * q;
              const float* pa = srow + (seg0 + j) * 3;  // in reach: a few of the pairs, cached in L1
              const float dx = (pa[0] - qa[0]) - kx;
              const float dy = (pa[1] - qa[1]) - ky;
              const float dz = (pa[2] - qa[2]) - kz;
              v = fmaxf(1.f - sqrtf(dx * dx + dy * dy + dz * dz) / sigma, 0.f);
            }
          }
          if constexpr (F32)
            cofii2p::split_tf32(v, A_hi[q * P::A_STRIDE + r], A_lo[q * P::A_STRIDE + r]);
          else
            A_s[q * P::A_STRIDE + r] = __float2bfloat16(v);
        }
        if (c + 1 < n_chunks)
          cofii2p::cp_async_wait<1>();
        else
          cofii2p::cp_async_wait<0>();
        __syncthreads();

        // acc_k += infl (TQ, RB) @ f (RB, CI)
        const E* Fs = F_s + slot * P::RB * P::F_STRIDE;
        if constexpr (F32)
          cofii2p::aggregate_tf32x3<P>(acc, A_hi, A_lo, Fs, wma, wna, g, t4);
        else
          cofii2p::aggregate_bf16<P>(acc, A_s, Fs, wma, wna, lane);
        __syncthreads();  // the next chunk's influence and load reuse A_s and this slot
      }
    }

    // park acc_k (bf16: rounded) as a (TQ, CI) matrix, then
    // out += acc_k (TQ, CI) @ W_k (CI, CO)
    cofii2p::park_acc<P>(P_s, acc, wma, wna, g, t4);
    __syncthreads();
    if constexpr (F32)
      cofii2p::contract_tf32x3<P, CI>(o, P_s, static_cast<const float*>(W) + (long)k * CO * CI, wmo, wno, g, t4);
    else
      cofii2p::contract_bf16<P, CI>(o, P_s, static_cast<const __nv_bfloat16*>(W) + (long)k * CO * CI, wmo, wno, g,
                                    t4, lane);
    __syncthreads();  // P_s is rewritten after the next kernel point
  }

  cofii2p::store_out<P>(out + ((long)b * M + m0) * Cout, o, Cout, TQ, wmo, wno, g, t4);
  for (int q = tid; q < TQ; q += kThreads) count[(long)b * M + m0 + q] = max(cnt_s[q], 1);
}

template <int CI, int CO, bool POOL, bool F32>
int launch_mma(const cofii2p::FusedArgs& a) {
  using P = MmaPlan<CI, CO, F32>;
  const int TQ = cofii2p::mma_tq(a.tile, P::TQ);
  if (a.M % TQ) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = kpconv_mma_kernel<CI, CO, POOL, F32>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.M / TQ, a.B), kThreads, P::SMEM, a.st>>>(a.q, a.s, a.f, a.f_bf16, a.W, a.kp, a.starts, a.out,
                                                          a.count, a.M, a.N, a.Cin, a.Cout, a.K, a.tile,
                                                          a.num_tiles, a.band, TQ, a.r2, a.sigma, a.mp_feats,
                                                          a.mp_bf16, a.Cmp, a.mp_out);
  return static_cast<int>(cudaGetLastError());
}

// Launch the kernel built for a's padded widths (every pair of
// COFII2P_MMA_WIDTHS) in the compute dtype F32 names; W as the header
// describes.  The block takes MmaPlan's queries (mma_tq), so #1 and #16's
// conv half sum in the same order.  A width over 512, a band over N or a
// tile the block does not divide is refused before anything runs.
template <bool POOL, bool F32>
int launch_mma_widths(const cofii2p::FusedArgs& a) {
  if (!cofii2p::mma_widths(a.Cin, a.Cout) || a.tile < 1 || a.band > a.N || (POOL && a.Cmp < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ci = cofii2p::mma_pad(a.Cin), co = cofii2p::mma_pad(a.Cout);
#define COFII2P_MMA_LAUNCH(ci_, co_) \
  if (ci == ci_ && co == co_) return launch_mma<ci_, co_, POOL, F32>(a);
  COFII2P_MMA_WIDTHS(COFII2P_MMA_LAUNCH)
#undef COFII2P_MMA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
