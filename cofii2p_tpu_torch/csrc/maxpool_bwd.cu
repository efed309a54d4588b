// Backward of the banded maxpool for Hopper: routes the cotangent to the
// arg-max rows, transposed over support tiles (static bands).
//
// Replaces: cofii2p_tpu/ops/maxpool_kernel.py::_bwd (body
// _maxpool_bwd_kernel).  Same function: for each support row j and
// channel c,
//   g_feats[j, c] = sum_m gs[m, c] * [j in m's neighbourhood] * [f[j, c] == out[m, c]]
// where the neighbourhood is the forward's (j in the static band of m's
// 128-row tile, d2 <= r2 centred on that tile's first query) and gs is the
// cotangent already divided by max(tie count, 1) (maxpool_kernel.py:478-483),
// so exact duplicates split it evenly.
//
// What bounds it on the H100: reading out and gs, (B, M, C) each, for every
// query in reach of a block's rows, and the membership tests.  A block owns
// TS support rows and 128 channels; it walks the contiguous window of
// query tiles whose bands touch its rows (ops/banded.py::bwd_geometry, on
// the host), builds per tile a membership bitmask of (row, query) in shared
// memory with warp ballots (one thread per query of the 128-row tile), and
// then each thread, one channel, walks the set bits of each of its rows and
// adds gs[m, c] where f[j, c] equals out[m, c].  Its rows' features stay in
// registers; out and gs are read 128 channels at a time, coalesced.  No
// atomics: the sum is in a fixed order.
//
// Exactness: membership is bit-identical to the forward's (centring on the
// forward tile's first query, not on a chunk's, and the round-to-nearest
// intrinsics of common.cuh), so no maximum loses its gradient.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;            // channels per block; queries per tile
constexpr int kMaxTS = 32;               // support rows per block at most
constexpr int kQW = kThreads / 32;       // mask words per support row

__global__ void __launch_bounds__(kThreads) maxpool_bwd_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const void* __restrict__ feats, int f_bf16, const void* __restrict__ pooled,
    const float* __restrict__ gs, const int* __restrict__ starts,
    const int* __restrict__ qstart_blk, float* __restrict__ g_feats, int M,
    int N, int C, int tile, int num_tiles, int band, int TS, int n_qtiles,
    float r2) {
  __shared__ float sp_s[kMaxTS * 3];
  __shared__ float pc_s[kMaxTS * 3];
  __shared__ unsigned mask_s[kMaxTS * kQW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int c = blockIdx.y * kThreads + tid;
  const int s0 = blockIdx.x * TS;

  if (tid < TS * 3) sp_s[tid] = s_pts[((long)b * N + s0) * 3 + tid];

  float fv[kMaxTS], acc[kMaxTS];
#pragma unroll
  for (int s = 0; s < kMaxTS; ++s) {
    acc[s] = 0.f;
    fv[s] = (s < TS && c < C) ? cofii2p::load_f(feats, ((long)b * N + s0 + s) * C + c, f_bf16) : 0.f;
  }

  const int t_first = qstart_blk[blockIdx.x];
  for (int tt = 0; tt < n_qtiles; ++tt) {
    const int t = t_first + tt;
    if (t >= num_tiles) break;
    const int start = starts[b * num_tiles + t];
    const int lo = max(start - s0, 0), hi = min(start + band - s0, TS);
    if (lo >= hi) continue;
    const float* ref_p = q_pts + ((long)b * M + (long)t * tile) * 3;
    __syncthreads();  // the previous tile is done with pc_s and mask_s
    if (tid < TS * 3) pc_s[tid] = __fsub_rn(sp_s[tid], ref_p[tid % 3]);
    __syncthreads();

    // bit q of row s: query t * tile + q has row s0 + s in its neighbourhood
    float qc[3] = {0.f, 0.f, 0.f};
    const bool valid = tid < tile;
    if (valid)
      for (int d = 0; d < 3; ++d)
        qc[d] = __fsub_rn(q_pts[((long)b * M + (long)t * tile + tid) * 3 + d], ref_p[d]);
    for (int s = 0; s < TS; ++s) {
      const bool in = valid && s >= lo && s < hi &&
                      cofii2p::membership_d2(qc, pc_s[3 * s], pc_s[3 * s + 1], pc_s[3 * s + 2]) <= r2;
      const unsigned bits = __ballot_sync(0xffffffffu, in);
      if (lane == 0) mask_s[s * kQW + warp] = bits;
    }
    __syncthreads();

    if (c < C) {
#pragma unroll
      for (int s = 0; s < kMaxTS; ++s) {
        if (s >= TS) break;
        for (int w = 0; w < kQW; ++w) {
          unsigned bits = mask_s[s * kQW + w];
          while (bits) {
            const long o = ((long)b * M + (long)t * tile + w * 32 + __ffs(bits) - 1) * C + c;
            bits &= bits - 1;
            if (cofii2p::load_f(pooled, o, f_bf16) == fv[s]) acc[s] += gs[o];
          }
        }
      }
    }
  }

  if (c >= C) return;
#pragma unroll
  for (int s = 0; s < kMaxTS; ++s) {
    if (s >= TS) break;
    g_feats[((long)b * N + s0 + s) * C + c] = acc[s];
  }
}

}  // namespace

// q (B, M, 3), s (B, N, 3) fp32; f (B, N, C) and pooled (B, M, C), the
// forward's input and output, fp32 or bf16; gs (B, M, C) fp32 cotangent
// divided by the tie count; starts (B, num_tiles) int32 static band
// starts; qstart_blk (N / TS) int32 first query tile of each support
// tile's window of n_qtiles tiles; g_feats (B, N, C) fp32.
// TS divides N, TS <= 32, tile <= 128.
extern "C" int maxpool_bwd_launch(const void* q, const void* s, const void* f,
                                  int f_bf16, const void* pooled,
                                  const void* gs, const void* starts,
                                  const void* qstart_blk, void* g_feats, int B,
                                  int M, int N, int C, int tile, int num_tiles,
                                  int band, int TS, int n_qtiles, float r2,
                                  void* stream) {
  if (TS < 1 || TS > kMaxTS || N % TS || tile < 1 || tile > kThreads ||
      M % tile || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(N / TS, (C + kThreads - 1) / kThreads, B);
  maxpool_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16,
      pooled, static_cast<const float*>(gs), static_cast<const int*>(starts),
      static_cast<const int*>(qstart_blk), static_cast<float*>(g_feats), M, N,
      C, tile, num_tiles, band, TS, n_qtiles, r2);
  return static_cast<int>(cudaGetLastError());
}
