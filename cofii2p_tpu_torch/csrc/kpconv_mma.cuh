// Banded KPConv on the tensor cores: kernel #1 (and #16's conv half) for
// bf16 compute.
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::banded_kpconv_fused_pallas
// (body _agg_fused_kernel) for the calls that compute in bf16, every
// serving call.  The function is kpconv_fused.cuh's CONTRACT mode:
//   out[m, :] = sum_k ( sum_j infl_k(q_m, s_j) f_j ) @ W_k,
//   count[m]  = max(#in-reach band rows, 1),
// over the band rows j of m's 128-query tile within kernel reach; out is
// fp32 and unnormalised.  POOL adds kernel #16's shortcut, as there.
//
// What bounds it on the H100: at the deep levels (Cin = Cout = 512) the
// two products, 2 * TQ * rows * Cin and 2 * TQ * Cin * Cout multiply-adds
// per kernel point and block; at the shallow levels the influence math over
// the band.  Both products run on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulate) at the TPU kernel's rounding points (its
// jnp.dot(infl, f) and jnp.dot(acc.astype(cdtype), w) with fp32 results):
//  - aggregation: for kernel point k and a chunk of RB active rows, the
//    (TQ, RB) influence tile is computed in fp32, rounded to bf16 and
//    staged in shared memory as the A operand; the rows' features, bf16,
//    are the B operand (ldmatrix.trans), staged by 16-byte cp.async, double
//    buffered, the next chunk in flight while this one's influence is
//    computed; acc_k (TQ, Cin) accumulates in fp32 fragments;
//  - contraction: acc_k is rounded to bf16 into shared memory (A, through
//    ldmatrix) and out (TQ, Cout) += acc_k @ W_k accumulates in fp32
//    fragments across the 15 kernel points.  W arrives from the wrapper as
//    bf16, transposed to (K, Cout, Cin) and its Cin permuted within each
//    32-channel group, so one 16-byte load from L2 is a lane's B fragment
//    pair for two k-steps: W is read once per block, half the bytes of the
//    fp32 copy the CUDA-core template takes.
// The row list, the chunk loader and both products are mma.cuh's, shared
// with the k-NN (tau) kernel of kpconv_tau_mma.cuh.
// Once the products are this cheap, a zero-influence pair costs a bit test
// and a zero, so a block takes 64 queries (32 at 512 channels, MmaPlan),
// not <= 32; up to 128 channels two blocks share an SM, so that one
// block's influence pass and barriers overlap the other's products.
//
// Membership is kpconv_fused.cuh's, unchanged: d2 centred on the tile's
// first query with the _rn intrinsics (cofii2p::membership_d2), warp
// ballots, exact counts, an ordered active-row list per 2048-row segment.
// The ballots are kept as per-query bitmasks (as the POOL mode kept them),
// so the influence pass tests a bit instead of recomputing d2 for every
// kernel point; the influence itself is the CUDA-core template's
// expression, offsets from the uncentred coordinates.  Counts are
// therefore bit-equal to the plain version's, and only the order of the
// fp32 sums differs from the CUDA-core template's.  #16's conv half is
// this kernel at this block size, so it is bit-equal to #1's.
#pragma once

#include <cstdint>

#include "kpconv_fused.cuh"
#include "kpconv_mma_plan.cuh"
#include "mma.cuh"

namespace {

using cofii2p::MmaPlan;
static_assert(cofii2p::kMmaThreads == kThreads && cofii2p::kMmaSeg == kSeg && cofii2p::kMmaWords == kWords,
              "kpconv_mma_plan.cuh plans for kpconv_fused.cuh's geometry");

// POOL's max over one membership segment: kpconv_fused.cuh's pool_segment
// (the same items, the same result: a max is exact in any order) with four
// member rows' loads in flight at a time.  Beside the tensor-core products
// the one-load walk waits on L2 once per member row: #16 took 7.0 ms a
// bf16 serving forward against 5.3 for #1 and #3 apart, 5.6 with this walk
// (H100 80GB HBM3).  In the CUDA-core template this walk made the fp32 #16
// slower instead (16.0 against 10.2 ms at encoder2_1), so each keeps its own.
template <int V>
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
      unsigned bits = mask[q * kWords + w];
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

// grid (M / TQ, B), kThreads threads, MmaPlan<CI, CO>::SMEM bytes of
// dynamic shared memory.  TQ (runtime) divides the band tile and is at
// most the plan's; Cin <= CI, Cout <= CO.  Wt (K, CO, CI) bf16 as the
// header describes; feats bf16 or fp32 (rounded to bf16 on load).
template <int CI, int CO, bool POOL>
__global__ void __launch_bounds__(kThreads, (MmaPlan<CI, CO>::MIN_BLOCKS)) kpconv_mma_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const void* __restrict__ feats, int f_bf16, const __nv_bfloat16* __restrict__ Wt,
    const float* __restrict__ kp, const int* __restrict__ starts,
    float* __restrict__ out, int* __restrict__ count, int M, int N, int Cin,
    int Cout, int K, int tile, int num_tiles, int band, int TQ, float r2,
    float sigma, const void* __restrict__ mp_feats, int mp_bf16, int Cmp,
    void* __restrict__ mp_out) {
  using P = MmaPlan<CI, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* F_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* P_s = F_s + 2 * P::RB * P::F_STRIDE;
  __nv_bfloat16* A_s = P_s + P::TQ * P::P_STRIDE;
  unsigned* mask = reinterpret_cast<unsigned*>(A_s + P::TQ * P::A_STRIDE);
  int* act = reinterpret_cast<int*>(mask + P::TQ * kWords);
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

  const bool f_vec = cofii2p::stage_vec<__nv_bfloat16>(feats, f_bf16, Cin);
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
              pool_segment_x4<4>(mask, mp_feats, mp_bf16, mp_out, Cmp, TQ, nwords, seg0 == 0, seg1 == band, cnt_s,
                                 mrow0, out0, tid);
            else
              pool_segment_x4<1>(mask, mp_feats, mp_bf16, mp_out, Cmp, TQ, nwords, seg0 == 0, seg1 == band, cnt_s,
                                 mrow0, out0, tid);
            __syncthreads();
          }
        }
      }
      const int n_act = *n_act_s;
      const int n_chunks = (n_act + P::RB - 1) / P::RB;

      // the features of active rows [c * RB, c * RB + RB) as bf16 into a
      // slot, zero past the list and past Cin
      auto load_chunk = [&](int c, int slot) {
        cofii2p::stage_rows<P, CI>(F_s + slot * P::RB * P::F_STRIDE, feats, f_bf16, f_vec, Cin,
                                   frow0 + (long)seg0 * Cin, act, c * P::RB, n_act, tid);
      };

      if (n_chunks > 0) load_chunk(0, 0);
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c & 1;
        if (c + 1 < n_chunks) load_chunk(c + 1, slot ^ 1);
        // influence of kernel point k for (query, chunk row), rounded to bf16
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
          A_s[q * P::A_STRIDE + r] = __float2bfloat16(v);
        }
        if (c + 1 < n_chunks)
          cofii2p::cp_async_wait<1>();
        else
          cofii2p::cp_async_wait<0>();
        __syncthreads();

        // acc_k += infl (TQ, RB) @ f (RB, CI)
        cofii2p::aggregate_bf16<P>(acc, A_s, F_s + slot * P::RB * P::F_STRIDE, wma, wna, lane);
        __syncthreads();  // the next chunk's influence and load reuse A_s and this slot
      }
    }

    // park acc_k rounded to bf16 as a (TQ, CI) matrix, then
    // out += acc_k (TQ, CI) @ W_k (CI, CO)
    cofii2p::park_acc<P>(P_s, acc, wma, wna, g, t4);
    __syncthreads();
    cofii2p::contract_bf16<P, CI>(o, P_s, Wt + (long)k * CO * CI, wmo, wno, g, t4, lane);
    __syncthreads();  // P_s is rewritten after the next kernel point
  }

  cofii2p::store_out<P>(out + ((long)b * M + m0) * Cout, o, Cout, TQ, wmo, wno, g, t4);
  for (int q = tid; q < TQ; q += kThreads) count[(long)b * M + m0 + q] = max(cnt_s[q], 1);
}

template <int CI, int CO, bool POOL>
int launch_mma(int B, cudaStream_t st, const float* q, const float* s, const void* f, int f_bf16,
               const __nv_bfloat16* Wt, const float* kp, const int* starts, float* out, int* count, int M, int N,
               int Cin, int Cout, int K, int tile, int num_tiles, int band, float r2, float sigma,
               const void* mp_feats, int mp_bf16, int Cmp, void* mp_out) {
  using P = MmaPlan<CI, CO>;
  const int TQ = cofii2p::mma_tq(tile, P::TQ);
  if (M % TQ) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = kpconv_mma_kernel<CI, CO, POOL>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(M / TQ, B), kThreads, P::SMEM, st>>>(q, s, f, f_bf16, Wt, kp, starts, out, count, M, N, Cin, Cout, K,
                                                   tile, num_tiles, band, TQ, r2, sigma, mp_feats, mp_bf16, Cmp,
                                                   mp_out);
  return static_cast<int>(cudaGetLastError());
}

// Launch the tensor-core kernel (cofii2p::mma_widths(Cin, Cout)); Wt as the
// header describes.  The block takes MmaPlan's queries (mma_tq), so #1 and
// #16's conv half sum in the same order.
template <bool POOL>
int launch_mma_widths(int B, cudaStream_t st, const float* q, const float* s, const void* f, int f_bf16,
                      const void* Wt, const float* kp, const int* starts, float* out, int* count, int M, int N,
                      int Cin, int Cout, int K, int tile, int num_tiles, int band, float r2, float sigma,
                      const void* mp_feats = nullptr, int mp_bf16 = 0, int Cmp = 0, void* mp_out = nullptr) {
  if (!cofii2p::mma_widths(Cin, Cout) || tile < 1 || band > N) return static_cast<int>(cudaErrorInvalidValue);
  const int ci = cofii2p::mma_pad(Cin), co = cofii2p::mma_pad(Cout);
  auto w = static_cast<const __nv_bfloat16*>(Wt);
#define COFII2P_MMA_LAUNCH(ci_, co_)                                                                            \
  if (ci == ci_ && co == co_)                                                                                   \
    return launch_mma<ci_, co_, POOL>(B, st, q, s, f, f_bf16, w, kp, starts, out, count, M, N, Cin, Cout, K,   \
                                      tile, num_tiles, band, r2, sigma, mp_feats, mp_bf16, Cmp, mp_out);
  COFII2P_MMA_WIDTHS(COFII2P_MMA_LAUNCH)
#undef COFII2P_MMA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
