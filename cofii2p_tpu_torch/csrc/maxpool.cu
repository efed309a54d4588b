// Banded neighborhood maxpool for Hopper (the strided blocks' shortcut),
// and the tie count of its backward.
//
// Replaces: cofii2p_tpu/ops/maxpool_kernel.py::banded_maxpool_pallas
// (body _maxpool_kernel).  Same function: out[m, c] = max of f[j, c] over
// the band rows j of m's 128-query tile within kernel reach, and 0 where
// no band row is in reach; out keeps the feature dtype.  With COUNT it
// replaces maxpool_kernel.py::_match_count (body _count_kernel): cnt[m, c]
// = number of those rows with f[j, c] == out[m, c], in fp32, on the same
// grid and the same membership, so the count is taken over exactly the
// rows the forward maxed over.
//
// What bounds it on the H100: reading feature rows.  The TPU kernel swept a
// (tile, band chunk, channel chunk) masked select through VMEM because
// Mosaic could not hold 1-bit masks in minor dims; here membership is a
// bitmask in shared memory instead: the block's threads test each band row
// against the block's TQ queries once (ballots, 1 bit per query and row),
// then each thread owns one channel and walks only the set bits of each
// query, so a feature row is read only where it is in reach, 128 channels
// at a time in one coalesced load.  The count pass has the same shape: it
// reads out[m, c] once per (query, channel) and compares instead of maxing.
//
// With TAU it replaces maxpool_kernel.py::banded_maxpool_tau_pallas (body
// _maxpool_kernel_tau, kernel #8), the reference's k-NN maxpool: the
// membership is d2 <= tau[m], each query's threshold from kernel #5, in
// place of the shared radius, with no radius mask.  COUNT with TAU is
// _match_count with thr = tau, the tie count of _tau_bwd; either count
// takes the forward's dynamic window starts where it had them.
//
// Exactness: it is a select, so the result is bit-equal to the plain
// version in fp32 and in bf16.  Membership d2 uses the same centred,
// FMA-free arithmetic as the KPConv kernel (common.cuh).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTQ = 16;        // queries per block at most
constexpr int kSeg = 1024;     // band rows per mask segment
constexpr int kWords = kSeg / 32;

// COUNT: read the forward max from ``pooled`` and write the tie count to
// ``cnt``; otherwise write the max to ``out``.  TAU: membership d2 <=
// tau[m] instead of d2 <= r2.
template <bool COUNT, bool TAU = false>
__global__ void __launch_bounds__(kThreads) maxpool_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const void* __restrict__ feats, int f_bf16, const int* __restrict__ starts,
    void* __restrict__ out, const void* __restrict__ pooled,
    float* __restrict__ cnt, int M, int N, int C, int tile, int band, int TQ,
    float r2, const float* __restrict__ tau = nullptr) {
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

  float mx[kTQ];  // running max, or under COUNT the forward max
  float ties[kTQ];
  bool has[kTQ];
#pragma unroll
  for (int q = 0; q < kTQ; ++q) {
    mx[q] = -INFINITY;
    ties[q] = 0.f;
    has[q] = false;
    if (COUNT && q < TQ && c < C)
      mx[q] = cofii2p::load_f(pooled, ((long)b * M + m0 + q) * C + c, f_bf16);
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
        if (bits) has[q] = true;
        while (bits) {
          const int j = seg0 + w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          if (c >= C) continue;
          const float v = cofii2p::load_f(feats, frow0 + (long)j * C + c, f_bf16);
          if (COUNT)
            ties[q] += v == mx[q] ? 1.f : 0.f;
          else
            mx[q] = fmaxf(mx[q], v);
        }
      }
    }
    __syncthreads();
  }

  if (c >= C) return;
#pragma unroll
  for (int q = 0; q < kTQ; ++q) {
    if (q >= TQ) break;
    const float v = has[q] ? mx[q] : 0.f;
    const long o = ((long)b * M + m0 + q) * C + c;
    if (COUNT)
      cnt[o] = ties[q];
    else if (f_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
    else
      static_cast<float*>(out)[o] = v;
  }
}

}  // namespace

// q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, C) fp32 or bf16,
// starts (B, M / tile) int32; out (B, M, C) in f's dtype.
// TQ divides tile and TQ <= 16.
extern "C" int maxpool_launch(const void* q, const void* s, const void* f,
                              int f_bf16, const void* starts, void* out, int B,
                              int M, int N, int C, int tile, int band, int TQ,
                              float r2, void* stream) {
  if (TQ < 1 || TQ > kTQ || tile % TQ || M % tile || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M / TQ, (C + kThreads - 1) / kThreads, B);
  maxpool_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      static_cast<const int*>(starts), out, nullptr, nullptr, M, N, C, tile,
      band, TQ, r2);
  return static_cast<int>(cudaGetLastError());
}

// The tie count: q, s, f, starts as above, pooled (B, M, C) the forward
// output in f's dtype; cnt (B, M, C) fp32.
extern "C" int maxpool_count_launch(const void* q, const void* s,
                                    const void* f, int f_bf16,
                                    const void* starts, const void* pooled,
                                    void* cnt, int B, int M, int N, int C,
                                    int tile, int band, int TQ, float r2,
                                    void* stream) {
  if (TQ < 1 || TQ > kTQ || tile % TQ || M % tile || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M / TQ, (C + kThreads - 1) / kThreads, B);
  maxpool_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      static_cast<const int*>(starts), nullptr, pooled,
      static_cast<float*>(cnt), M, N, C, tile, band, TQ, r2);
  return static_cast<int>(cudaGetLastError());
}

// The k-NN maxpool (kernel #8): q, s, f, starts, out as maxpool_launch,
// tau (B, M) fp32 the per-query squared thresholds.
extern "C" int maxpool_tau_launch(const void* q, const void* s, const void* f,
                                  int f_bf16, const void* starts,
                                  const void* tau, void* out, int B, int M,
                                  int N, int C, int tile, int band, int TQ,
                                  void* stream) {
  if (TQ < 1 || TQ > kTQ || tile % TQ || M % tile || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M / TQ, (C + kThreads - 1) / kThreads, B);
  maxpool_kernel<false, true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      static_cast<const int*>(starts), out, nullptr, nullptr, M, N, C, tile,
      band, TQ, 0.f, static_cast<const float*>(tau));
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
  maxpool_kernel<true, true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      static_cast<const int*>(starts), nullptr, pooled,
      static_cast<float*>(cnt), M, N, C, tile, band, TQ, 0.f,
      static_cast<const float*>(tau));
  return static_cast<int>(cudaGetLastError());
}
