// The tensor-core KPConv of the k-NN (tau) semantics, kernels #7
// (contraction fused in) and #6 (the aggregate written out), and, under
// radius membership, kernel #2 (the aggregate of the training forward);
// fp32 by 3xTF32 and bf16.
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::banded_kpconv_fused_tau_pallas
// (body _agg_fused_kernel_tau) and banded_kpconv_aggregate_tau_pallas
// (_agg_kernel_tau), the k-NN semantics of a reference checkpoint.  For each
// query m and the band rows j of m's 128-query tile:
//   member_j   = d2(q_m, s_j) <= tau[m]            (tau from kernel #5)
//   weighted[m, k, :] = sum_{member_j, d2 <= r2} infl_k(q_m, s_j) f_j,
//   count[m]   = max(#{member_j and active[j]}, 1),  active[j] = sum_c f_j > 0,
// r2 = the reach padded 10% for the layer's own kernel points kp (K, 3);
// #7 writes out[m, :] = sum_k weighted[m, k, :] @ W_k (fp32, unnormalised),
// #6 writes weighted (B, M, K, Cin) fp32.
//
// With TAU off it replaces banded_kpconv_aggregate_pallas (body _agg_kernel,
// kernel #2): the band rows with d2 <= r2 (the kernel reach of the
// canonical kernel points) are both the influence's and the count's,
//   weighted[m, k, :] = sum_{d2 <= r2} infl_k(q_m, s_j) f_j,
//   count[m] = max(#{d2 <= r2}, 1),
// over static bands or the caller's window starts; there are no active
// flags, so nothing runs ahead of it.
//
// What bounds it on the H100: #6 is bound by its (B, M, 15, Cin) fp32 write
// (315 MB a call at lvl0 with Cin = 32 and B = 8); #7 by the two products,
// 2 * TQ * rows * Cin per kernel point and block for the aggregation (most of
// a dense (queries, union of their neighbourhoods) tile is zero influence)
// and 2 * TQ * Cin * Cout for the contraction, and at the shallow levels by
// the influence math.  The CUDA-core template this replaces ran both
// products at one shared-memory read per FMA, 32 queries a block, and, on
// bands over 2048 rows (encoder4_2, 4_3 and 5_1), recomputed the whole
// membership pass for each of the 15 kernel points.  Here:
//  - membership runs once a block: every (query, band row) d2, the count
//    ballot (in tau and active) added up, the influence bit (in tau and in
//    reach) kept for the whole band, and one ordered list of the rows with
//    any influence bit, kept across the 15 kernel points, so the influence
//    pass tests a bit.  The bits cover kTauSeg = 3072 rows (TauPlan), every
//    band of the FPN (2304 at most); a wider band, which a band plan of the
//    caller's can ask for, is walked in slices of kTauSeg rows, each slice's
//    membership redone for every kernel point, as the CUDA-core template
//    did past 2048 rows;
//  - both products run on mma.sync, on the pieces that kpconv_mma.cuh's
//    kernel #1 also runs (mma.cuh: the row list, the chunk loader, the two
//    products): the (TQ, RB) influence tile of kernel point k, computed in
//    fp32 from the uncentred offsets, is the A operand;
//    the RB active rows' features, staged by 16-byte cp.async and double
//    buffered (the next chunk in flight while this one's influence is
//    computed), are the B operand; acc_k (TQ, Cin) accumulates in fp32
//    fragments.  #7 parks acc_k in shared memory and adds acc_k @ W_k into
//    out fragments, W from L2 in the fragment layout the wrapper ships; #6
//    stores acc_k from its fragments, each warp store a set of whole 32-byte
//    sectors (8 rows x 8 channels), so the write moves no byte twice;
//  - fp32 (round = 0) multiplies by 3xTF32: each operand is split into
//    tf32 hi + lo (cvt.rna), the influence once where it is computed (the
//    warps that share its rows load both halves), the features, acc_k and
//    W at their fragment loads; lo*hi + hi*lo + hi*hi
//    of each 8-deep k-step, summed from zero on the tensor cores, are added
//    to the fp32 accumulator with round-to-nearest (cofii2p::mma_tf32x3:
//    about 2^-21 relative, inside the 1e-4 gates that one TF32 product's
//    2^-11 would miss, and no drift from the tensor cores' own rounding
//    over a long chain); bf16 (round = 1) is one bf16
//    mma at the TPU kernel's rounding points, as kpconv_mma.cuh rounds:
//    influence and features to bf16 before their product, acc_k to bf16
//    before the contraction, W arriving rounded;
//  - 64 queries a block (32 where a width is 512), so each block walks the
//    band's membership for twice the queries.
//
// Exactness: d2 is centred on the first query of the 128-row band tile with
// the _rn intrinsics (cofii2p::membership_d2), as tau's producer and the
// plain version compute it, so members, ties at tau and counts are the
// plain version's bit for bit.  The influence takes its offset from the
// uncentred coordinates (exact for nearby points), as the CUDA-core
// template did; only the order of the fp32 sums differs from the plain
// version's.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kpconv_mma_plan.cuh"
#include "mma.cuh"

namespace cofii2p {

// One launch: #7 with Cout > 0 (W in the fragment layout: fp32
// ops/kpconv_kernel.py::tf32_weights, bf16 mma_weights), #6 with Cout = 0
// (out is weighted, W unused); active (B, N) is filled by
// row_active_kernel.  #2 (radius membership) reads neither tau nor active.
struct TauArgs {
  const float* q;
  const float* s;
  const void* f;
  int f_bf16;
  const void* W;
  const float* kp;
  const int* starts;
  const float* tau;
  const int* active;
  float* out;
  int* count;
  int B, M, N, Cin, Cout, K, tile, num_tiles, band;
  float r2, sigma;
  cudaStream_t st;
};

int tau_launch_f32(const TauArgs& a);   // kpconv_tau_f32.cu
int tau_launch_bf16(const TauArgs& a);  // kpconv_tau.cu
int radius_launch(const TauArgs& a, int round);  // kpconv_aggregate.cu: #2, both precisions

}  // namespace cofii2p

namespace {

constexpr int kTauThreads = cofii2p::kMmaThreads;

// active[r] = (sum_c f[r, c] > 0) in fp32 over R rows of C channels: one
// warp a row, lane-strided partial sums reduced in a fixed order.
__global__ void __launch_bounds__(kTauThreads) row_active_kernel(
    const void* __restrict__ feats, int f_bf16, long R, int C, int* __restrict__ active) {
  const long row = (long)blockIdx.x * (kTauThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += cofii2p::load_f(feats, row * C + c, f_bf16);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) active[row] = sum > 0.f;
}

// the active flags of every support row, ahead of a tau pass
inline void launch_active(cudaStream_t st, const void* f, int f_bf16, int B, int N, int C, int* active) {
  const long rows = (long)B * N;
  const int per_block = kTauThreads / 32;
  row_active_kernel<<<static_cast<unsigned>((rows + per_block - 1) / per_block), kTauThreads, 0, st>>>(
      f, f_bf16, rows, C, active);
}

// grid (M / TQ, B), kTauThreads threads, TauPlan<CI, CO, F32>::SMEM bytes
// of dynamic shared memory.  TQ (runtime) divides the band tile and is at
// most the plan's; Cin <= CI, Cout <= CO.  TAU: k-NN membership (#7, #6);
// otherwise radius membership, the aggregate only (#2).
template <int CI, int CO, bool F32, bool TAU>
__global__ void __launch_bounds__(kTauThreads, (cofii2p::TauPlan<CI, CO, F32>::MIN_BLOCKS))
    kpconv_tau_mma_kernel(const cofii2p::TauArgs a, int TQ) {
  using P = cofii2p::TauPlan<CI, CO, F32>;
  static_assert(TAU || !P::CONTRACT, "radius membership runs the aggregate (#2) only");
  using E = typename std::conditional<F32, float, __nv_bfloat16>::type;  // a staged operand
  constexpr int kWords = cofii2p::kTauWords;
  extern __shared__ __align__(16) unsigned char smem[];
  E* F_s = reinterpret_cast<E*>(smem);
  E* P_s = reinterpret_cast<E*>(smem + P::F_BYTES);
  // the influence tile: bf16, or fp32 split into tf32 hi (A_hi) and lo
  E* A_s = reinterpret_cast<E*>(smem + P::F_BYTES + P::P_BYTES);
  uint32_t* A_hi = reinterpret_cast<uint32_t*>(A_s);
  uint32_t* A_lo = A_hi + P::TQ * P::A_STRIDE;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + P::F_BYTES + P::P_BYTES + P::A_BYTES);
  unsigned short* act = reinterpret_cast<unsigned short*>(mask + P::TQ * kWords);
  float* pa_s = reinterpret_cast<float*>(act + cofii2p::kTauSeg);  // [slot][RB][3]
  float* qc_s = pa_s + 2 * P::RB * 3;
  float* qa_s = qc_s + P::TQ * 3;
  float* thr_s = qa_s + P::TQ * 3;
  int* cnt_s = reinterpret_cast<int*>(thr_s + P::TQ);
  int* warp_tot = cnt_s + P::TQ;
  int* n_act_s = warp_tot + kTauThreads / 32;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group and column
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * TQ;
  const int t = m0 / a.tile;
  const int start = a.starts[b * a.num_tiles + t];
  const float* ref_p = a.q + ((long)b * a.M + (long)t * a.tile) * 3;
  const float ref0 = ref_p[0], ref1 = ref_p[1], ref2 = ref_p[2];
  const float* srow = a.s + ((long)b * a.N + start) * 3;
  const int* act_row = TAU ? a.active + (long)b * a.N + start : nullptr;
  const int Cin = a.Cin;
  const long frow0 = ((long)b * a.N + start) * Cin;

  for (int i = tid; i < P::TQ * 3; i += kTauThreads) {
    qa_s[i] = i < TQ * 3 ? a.q[((long)b * a.M + m0) * 3 + i] : 0.f;
    qc_s[i] = __fsub_rn(qa_s[i], ref_p[i % 3]);
  }
  for (int i = tid; i < P::TQ; i += kTauThreads) {
    cnt_s[i] = 0;
    if constexpr (TAU) thr_s[i] = i < TQ ? a.tau[(long)b * a.M + m0 + i] : 0.f;
  }
  __syncthreads();

  const int wma = warp / P::WNA, wna = warp % P::WNA;  // this warp's aggregate tiles
  const int wmo = warp / P::WNO, wno = warp % P::WNO;  // and output tiles
  float o[P::MO][P::NO][4];
  if constexpr (P::CONTRACT) {
#pragma unroll
    for (int i = 0; i < P::MO; ++i)
#pragma unroll
      for (int j = 0; j < P::NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  }

  const bool f_vec = cofii2p::stage_vec<E>(a.f, a.f_bf16, Cin);
  const float inv_sigma = 1.f / a.sigma;
  // a band of one slice (every band of the FPN) takes its membership once
  // a block; over kTauSeg rows each slice's is redone for every kernel point
  const bool one_slice = a.band <= cofii2p::kTauSeg;
  for (int k = 0; k < a.K; ++k) {
    const float kx = a.kp[k * 3], ky = a.kp[k * 3 + 1], kz = a.kp[k * 3 + 2];
    float acc[P::MA][P::NA][4];
#pragma unroll
    for (int i = 0; i < P::MA; ++i)
#pragma unroll
      for (int j = 0; j < P::NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int seg0 = 0; seg0 < a.band; seg0 += cofii2p::kTauSeg) {
      const int seg1 = min(a.band, seg0 + cofii2p::kTauSeg);
      if (k == 0 || !one_slice) {
        // membership of the slice: the influence bits of every (query,
        // row), the counts (first pass), and the ordered list of rows with
        // any influence bit
        int base = 0;
        for (int r0 = seg0; r0 < seg1; r0 += kTauThreads) {
          const int j = r0 + tid;
          const bool valid = j < seg1;
          float px = 0.f, py = 0.f, pz = 0.f;
          bool act_j = false;
          if (valid) {
            px = __fsub_rn(srow[j * 3], ref0);
            py = __fsub_rn(srow[j * 3 + 1], ref1);
            pz = __fsub_rn(srow[j * 3 + 2], ref2);
            if constexpr (TAU) act_j = act_row[j] != 0;
          }
          bool any = false;
          for (int q = 0; q < TQ; ++q) {
            const float d2 = cofii2p::membership_d2(qc_s + 3 * q, px, py, pz);
            // k-NN: within tau and the padded reach, counted where active;
            // radius: within reach, which is also what the count counts
            const bool wtau = TAU ? valid && d2 <= thr_s[q] : valid;
            const bool in = wtau && d2 <= a.r2;
            any |= in;
            const unsigned bits = __ballot_sync(0xffffffffu, in);
            const unsigned counted = TAU ? __ballot_sync(0xffffffffu, wtau && act_j) : bits;
            if (lane == 0) {
              mask[q * kWords + (r0 - seg0) / 32 + warp] = bits;
              if (k == 0 && counted) atomicAdd(&cnt_s[q], __popc(counted));
            }
          }
          base = cofii2p::append_rows(any, j - seg0, act, base, warp_tot, lane, warp);
        }
        if (tid == 0) *n_act_s = base;
        __syncthreads();
      }
      const int n_act = *n_act_s;
      const int n_chunks = (n_act + P::RB - 1) / P::RB;
      const float* spts = srow + (long)seg0 * 3;

      // the features of active rows [c * RB, c * RB + RB) into a slot
      // (fp32 kept, or rounded to bf16), and their uncentred positions
      auto load_chunk = [&](int c, int slot) {
        const int a0 = c * P::RB;
        for (int i = tid; i < P::RB * 3; i += kTauThreads)
          pa_s[slot * P::RB * 3 + i] = a0 + i / 3 < n_act ? spts[act[a0 + i / 3] * 3 + i % 3] : 0.f;
        cofii2p::stage_rows<P, CI>(F_s + slot * P::RB * P::F_STRIDE, a.f, a.f_bf16, f_vec, Cin, Cin,
                                   frow0 + (long)seg0 * Cin, act, a0, n_act, tid);
      };

      if (n_chunks > 0) load_chunk(0, 0);
      __syncthreads();  // chunk 0's positions
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c & 1;
        if (c + 1 < n_chunks) load_chunk(c + 1, slot ^ 1);
        // influence of kernel point k for (query, chunk row) where the bit
        // is set: a thread keeps one chunk row, its bit and its position,
        // and takes every (kTauThreads / RB)-th query
        static_assert(kTauThreads % P::RB == 0, "a thread keeps one chunk row");
        const int r = tid % P::RB;
        const int a0 = c * P::RB;
        const bool live = a0 + r < n_act;
        const int j = live ? act[a0 + r] : 0;
        const unsigned* mrow = mask + (j >> 5);
        const unsigned bit = 1u << (j & 31);
        const float* pa = pa_s + (slot * P::RB + r) * 3;
        const float pa0 = pa[0], pa1 = pa[1], pa2 = pa[2];
#pragma unroll 4
        for (int q = tid / P::RB; q < P::TQ; q += kTauThreads / P::RB) {
          float v = 0.f;
          if (live && q < TQ && (mrow[q * kWords] & bit)) {
            const float* qa = qa_s + 3 * q;
            // (pa - qa) - kp, as kpconv_mma.cuh takes it for #1
            const float dx = (pa0 - qa[0]) - kx;
            const float dy = (pa1 - qa[1]) - ky;
            const float dz = (pa2 - qa[2]) - kz;
            const float d2 = dx * dx + dy * dy + dz * dz;
            // the root by rsqrt on the special-function unit, 1/sigma once
            // a block: ~1e-7 relative, against 1e-4 gates
            v = d2 > 0.f ? fmaxf(1.f - d2 * rsqrtf(d2) * inv_sigma, 0.f) : 1.f;
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

        // acc_k += infl (TQ, RB) @ f (RB, CI); in fp32 the influence was
        // split once, where it was computed (the WNA warps of its rows
        // share it)
        const E* Fs = F_s + slot * P::RB * P::F_STRIDE;
        if constexpr (F32)
          cofii2p::aggregate_tf32x3<P>(acc, A_hi, A_lo, Fs, wma, wna, g, t4);
        else
          cofii2p::aggregate_bf16<P>(acc, A_s, Fs, wma, wna, lane);
        __syncthreads();  // the next chunk's influence and load reuse A_s and this slot
      }
    }

    if constexpr (!P::CONTRACT) {
      // #6: acc_k, fp32, to weighted[b, m, k, :]; a warp's store covers 8
      // rows x 8 channels, whole 32-byte sectors
      const bool pairs = (Cin & 1) == 0;
#pragma unroll
      for (int i = 0; i < P::MA; ++i) {
#pragma unroll
        for (int jn = 0; jn < P::NA; ++jn) {
          const int col = (wna * P::NA + jn) * 8 + 2 * t4;
          if (col >= Cin) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = (wma * P::MA + i) * 16 + g + 8 * half;
            if (q >= TQ) continue;
            float* dst = a.out + (((long)b * a.M + m0 + q) * a.K + k) * Cin + col;
            if (pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(acc[i][jn][2 * half], acc[i][jn][2 * half + 1]);
            } else {
              dst[0] = acc[i][jn][2 * half];
              if (col + 1 < Cin) dst[1] = acc[i][jn][2 * half + 1];
            }
          }
        }
      }
    } else {
      // #7: park acc_k (bf16: rounded) as a (TQ, CI) matrix, then
      // out += acc_k (TQ, CI) @ W_k (CI, CO)
      cofii2p::park_acc<P>(P_s, acc, wma, wna, g, t4);
      __syncthreads();
      if constexpr (F32)
        cofii2p::contract_tf32x3<P, CI>(o, P_s, static_cast<const float*>(a.W) + (long)k * CO * CI, wmo, wno, g, t4);
      else
        cofii2p::contract_bf16<P, CI>(o, P_s, static_cast<const __nv_bfloat16*>(a.W) + (long)k * CO * CI, wmo, wno,
                                      g, t4, lane);
      __syncthreads();  // P_s is rewritten after the next kernel point
    }
  }

  if constexpr (P::CONTRACT) cofii2p::store_out<P>(a.out + ((long)b * a.M + m0) * a.Cout, o, a.Cout, TQ, wmo, wno, g, t4);
  for (int q = tid; q < TQ; q += kTauThreads) a.count[(long)b * a.M + m0 + q] = max(cnt_s[q], 1);
}

template <int CI, int CO, bool F32, bool TAU>
int launch_tau_mma(const cofii2p::TauArgs& a) {
  using P = cofii2p::TauPlan<CI, CO, F32>;
  const int TQ = cofii2p::mma_tq(a.tile, P::TQ);
  if (a.M % TQ) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = kpconv_tau_mma_kernel<CI, CO, F32, TAU>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.M / TQ, a.B), kTauThreads, P::SMEM, a.st>>>(a, TQ);
  return static_cast<int>(cudaGetLastError());
}

// The built kernel for a's padded widths (every pair of COFII2P_TAU_WIDTHS)
template <bool F32>
int launch_tau_widths(const cofii2p::TauArgs& a) {
  const int ci = cofii2p::mma_pad(a.Cin), co = a.Cout ? cofii2p::mma_pad(a.Cout) : 0;
#define COFII2P_TAU_LAUNCH(ci_, co_) \
  if (ci == ci_ && co == co_) return launch_tau_mma<ci_, co_, F32, true>(a);
  COFII2P_TAU_WIDTHS(COFII2P_TAU_LAUNCH)
#undef COFII2P_TAU_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// #2's kernel for a's padded Cin (every width of COFII2P_RADIUS_WIDTHS)
template <bool F32>
int launch_radius_widths(const cofii2p::TauArgs& a) {
  const int ci = cofii2p::mma_pad(a.Cin);
#define COFII2P_RADIUS_LAUNCH(ci_) \
  if (ci == ci_) return launch_tau_mma<ci_, 0, F32, false>(a);
  COFII2P_RADIUS_WIDTHS(COFII2P_RADIUS_LAUNCH)
#undef COFII2P_RADIUS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
