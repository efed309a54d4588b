// The tie count of the banded maxpool's backward (kernel #12) on the CUDA
// cores.
//
// Replaces: cofii2p_tpu/ops/maxpool_kernel.py::_match_count (body
// _count_kernel): cnt[m, c] = number of band rows j of m's 128-query tile
// within kernel reach with f[j, c] == out[m, c], out the forward max
// (maxpool_fwd.cu, kernels #3 and #8), in fp32, over the same membership,
// so the count is taken over exactly the rows the forward maxed over.
// With TAU the membership is d2 <= tau[m] (the tie count of _tau_bwd);
// either takes the forward's dynamic window starts where it had them.
//
// What bounds it on the H100: reading feature rows.  Membership is a
// bitmask in shared memory: the block's threads test each band row against
// the block's TQ queries once (ballots, 1 bit per query and row), then
// each thread owns one channel and walks the set bits of each query,
// reading out[m, c] once per (query, channel) and comparing each member
// row's feature with it.
//
// Exactness: counts of exact equalities, with membership d2 in the same
// centred, FMA-free arithmetic as the forward (common.cuh).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTQ = 16;        // queries per block at most
constexpr int kSeg = 1024;     // band rows per mask segment
constexpr int kWords = kSeg / 32;

// Reads the forward max from ``pooled`` and writes the tie count to
// ``cnt``.  TAU: membership d2 <= tau[m] instead of d2 <= r2.
template <bool TAU>
__global__ void __launch_bounds__(kThreads) count_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const void* __restrict__ feats, int f_bf16, const int* __restrict__ starts,
    const void* __restrict__ pooled, float* __restrict__ cnt, int M, int N,
    int C, int tile, int band, int TQ, float r2, const float* __restrict__ tau) {
  __shared__ float qc_s[kTQ * 3];
  __shared__ float thr_s[kTQ];
  __shared__ unsigned mask_s[kTQ * kWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TQ;
  const int c = blockIdx.y * kThreads + tid;
  const int t = m0 / tile;
  const int start = starts[b * (M / tile) + t];
  const float* ref_p = q_pts + ((long)b * M + (long)t * tile) * 3;
  const float* srow = s_pts + ((long)b * N + start) * 3;
  const long frow0 = ((long)b * N + start) * C;

  if (tid < TQ * 3) qc_s[tid] = __fsub_rn(q_pts[((long)b * M + m0) * 3 + tid], ref_p[tid % 3]);
  if (TAU && tid < TQ) thr_s[tid] = tau[(long)b * M + m0 + tid];
  __syncthreads();

  float mx[kTQ];  // the forward max
  float ties[kTQ];
#pragma unroll
  for (int q = 0; q < kTQ; ++q) {
    mx[q] = -INFINITY;
    ties[q] = 0.f;
    if (q < TQ && c < C) mx[q] = cofii2p::load_f(pooled, ((long)b * M + m0 + q) * C + c, f_bf16);
  }

  for (int seg0 = 0; seg0 < band; seg0 += kSeg) {
    const int seg1 = min(band, seg0 + kSeg);
    for (int r0 = seg0; r0 < seg1; r0 += kThreads) {
      const int j = r0 + tid;
      const bool valid = j < seg1;
      float px = 0.f, py = 0.f, pz = 0.f;
      if (valid) {
        px = __fsub_rn(srow[j * 3], ref_p[0]);
        py = __fsub_rn(srow[j * 3 + 1], ref_p[1]);
        pz = __fsub_rn(srow[j * 3 + 2], ref_p[2]);
      }
      for (int q = 0; q < TQ; ++q) {
        const bool in = valid && cofii2p::membership_d2(qc_s + 3 * q, px, py, pz) <= (TAU ? thr_s[q] : r2);
        const unsigned bits = __ballot_sync(0xffffffffu, in);
        if (lane == 0) mask_s[q * kWords + (r0 - seg0) / 32 + warp] = bits;
      }
    }
    __syncthreads();
    const int nwords = (seg1 - seg0 + 31) / 32;
#pragma unroll
    for (int q = 0; q < kTQ; ++q) {
      if (q >= TQ) break;
      for (int w = 0; w < nwords; ++w) {
        unsigned bits = mask_s[q * kWords + w];
        while (bits) {
          const int j = seg0 + w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          if (c >= C) continue;
          const float v = cofii2p::load_f(feats, frow0 + (long)j * C + c, f_bf16);
          ties[q] += v == mx[q] ? 1.f : 0.f;
        }
      }
    }
    __syncthreads();
  }

  if (c >= C) return;
#pragma unroll
  for (int q = 0; q < kTQ; ++q) {
    if (q >= TQ) break;
    cnt[((long)b * M + m0 + q) * C + c] = ties[q];
  }
}

}  // namespace

// The tie count: q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, C) fp32 or
// bf16, starts (B, M / tile) int32, pooled (B, M, C) the forward output in
// f's dtype; cnt (B, M, C) fp32.  TQ divides tile and TQ <= 16.
extern "C" int maxpool_count_launch(const void* q, const void* s,
                                    const void* f, int f_bf16,
                                    const void* starts, const void* pooled,
                                    void* cnt, int B, int M, int N, int C,
                                    int tile, int band, int TQ, float r2,
                                    void* stream) {
  if (TQ < 1 || TQ > kTQ || tile % TQ || M % tile || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M / TQ, (C + kThreads - 1) / kThreads, B);
  count_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      static_cast<const int*>(starts), pooled, static_cast<float*>(cnt), M, N,
      C, tile, band, TQ, r2, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The tie count under k-NN semantics: q, s, f, starts, pooled, cnt as
// maxpool_count_launch, tau (B, M) fp32 the per-query squared thresholds.
extern "C" int maxpool_count_tau_launch(const void* q, const void* s,
                                        const void* f, int f_bf16,
                                        const void* starts, const void* tau,
                                        const void* pooled, void* cnt, int B,
                                        int M, int N, int C, int tile,
                                        int band, int TQ, void* stream) {
  if (TQ < 1 || TQ > kTQ || tile % TQ || M % tile || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M / TQ, (C + kThreads - 1) / kThreads, B);
  count_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      static_cast<const int*>(starts), pooled, static_cast<float*>(cnt), M, N,
      C, tile, band, TQ, 0.f, static_cast<const float*>(tau));
  return static_cast<int>(cudaGetLastError());
}
