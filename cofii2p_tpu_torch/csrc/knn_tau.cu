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
// What bounds it on the H100: the selection arithmetic, not memory (it
// reads each band's coordinates once and writes 4 bytes per query).  The
// TPU kernel held the (tile, band) d2 block in VMEM, up to 1.2 MB, and
// bisected on it 48 times; 227 KB of shared memory cannot hold that block.
// Here a block stages its band's centred coordinates in shared memory
// (12 bytes a row), each query gets a warp, and d2 is recomputed on every
// pass instead of stored.  The k-th value is found by a radix select over
// the fp32 bit patterns (non-negative floats order as their uint32 bits):
// four passes, each a 256-bin histogram of the next 8 bits among the rows
// whose higher bits match the prefix found so far (lanes with one bin
// merged by __match_any_sync before one shared atomic).  A fifth pass
// counts rows <= kth and takes the least d2 > kth: a count above kk means
// the (kk+1)-th value ties kth (duplicated points), as the TPU's tie rule.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float d2_of(const float* qc, const float* band_s, int j) {
  return cofii2p::membership_d2(qc, band_s[3 * j], band_s[3 * j + 1], band_s[3 * j + 2]);
}

__global__ void __launch_bounds__(kThreads) knn_tau_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int* __restrict__ starts, float* __restrict__ tau, int M, int N,
    int tile, int num_tiles, int band, int QB, int kk) {
  extern __shared__ float smem[];
  float* band_s = smem;                                        // band * 3
  int* hist_all = reinterpret_cast<int*>(smem + 3 * band);     // kWarps * 256

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QB;
  const int t = m0 / tile;
  const int start = starts[b * num_tiles + t];
  const float* ref = q_pts + ((long)b * M + (long)t * tile) * 3;
  const float* srow = s_pts + ((long)b * N + start) * 3;
  for (int i = tid; i < band * 3; i += kThreads) band_s[i] = __fsub_rn(srow[i], ref[i % 3]);
  __syncthreads();

  int* hist = hist_all + warp * 256;
  const float c_pad = (float)(1.0 + 1e-5), e_pad = (float)1e-12;
  const float c_fb = (float)(1.0 + 2e-6), e_fb = (float)2e-12;
  for (int q = warp; q < QB; q += kWarps) {
    const float* qp = q_pts + ((long)b * M + m0 + q) * 3;
    float qc[3];
    for (int d = 0; d < 3; ++d) qc[d] = __fsub_rn(qp[d], ref[d]);

    // radix select of the kk-th smallest bit pattern, 8 bits a pass
    unsigned prefix = 0, mask = 0;
    int r = kk;  // rank sought among the rows matching the prefix
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = lane; i < 256; i += 32) hist[i] = 0;
      __syncwarp();
      for (int j0 = 0; j0 < band; j0 += 32) {
        const int j = j0 + lane;
        int bin = -1;
        if (j < band) {
          const unsigned u = __float_as_uint(d2_of(qc, band_s, j));
          if ((u & mask) == prefix) bin = (u >> shift) & 255;
        }
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
      __syncwarp();
      int c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[lane * 8 + i];
        sum += c[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int excl = incl - sum;
      const bool mine = excl < r && r <= incl;
      const int src = __ffs(__ballot_sync(kFull, mine)) - 1;
      int digit = 0, r_in = 0;
      if (mine) {
        int cum = excl;
        bool found = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!found && cum + c[i] >= r) {
            found = true;
            digit = lane * 8 + i;
            r_in = r - cum;
          }
          cum += c[i];
        }
      }
      digit = __shfl_sync(kFull, digit, src);
      r = __shfl_sync(kFull, r_in, src);
      prefix |= static_cast<unsigned>(digit) << shift;
      mask |= 255u << shift;
      __syncwarp();
    }
    const float kth = __uint_as_float(prefix);

    // rows <= kth, and the least d2 above it
    int le = 0;
    float above = INFINITY;
    for (int j = lane; j < band; j += 32) {
      const float v = d2_of(qc, band_s, j);
      le += v <= kth;
      if (v > kth) above = fminf(above, v);
    }
    le = __reduce_add_sync(kFull, le);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) above = fminf(above, __shfl_xor_sync(kFull, above, o));
    float nxt;
    if (le > kk)
      nxt = kth;  // the (kk+1)-th value ties the kk-th
    else if (kk < band)
      nxt = above;
    else
      nxt = __fadd_rn(__fmul_rn(kth, c_fb), e_fb);  // no (kk+1)-th row
    const float mid = __fmul_rn(0.5f, __fadd_rn(kth, nxt));
    const float pad = __fadd_rn(__fmul_rn(kth, c_pad), e_pad);
    if (lane == 0) tau[(long)b * M + m0 + q] = fmaxf(mid, pad);
  }
}

}  // namespace

// q (B, M, 3) fp32, s (B, N, 3) fp32, starts (B, num_tiles) int32 (each
// tile's band of ``band`` rows); tau (B, M) fp32.  QB queries per block,
// QB divides tile; 1 <= kk <= band.
extern "C" int knn_tau_launch(const void* q, const void* s, const void* starts,
                              void* tau, int B, int M, int N, int tile,
                              int num_tiles, int band, int QB, int kk,
                              void* stream) {
  if (QB < 1 || tile % QB || M != tile * num_tiles || band > N || band < 1 ||
      kk < 1 || kk > band)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 3 * band + sizeof(int) * kWarps * 256;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_tau_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(M / QB, B);
  knn_tau_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(s),
      static_cast<const int*>(starts), static_cast<float*>(tau), M, N, tile,
      num_tiles, band, QB, kk);
  return static_cast<int>(cudaGetLastError());
}
