// Dynamic window placement for Hopper: kernel #19.
//
// Replaces no TPU kernel: cofii2p_tpu/ops/banded.py::dynamic_band_starts
// and dynamic_knn_starts are plain jnp, which XLA fuses.  PyTorch runs the
// port's plain version (ops/banded.py::_best_windows) as eight full-size
// fp32 broadcast passes over every (query, sampled row) pair, then a
// comparison and a sum: ~66 bytes of traffic a pair, ~22 GB for a bf16
// B = 8 serving forward's five calls, to place 5 x 8 x 40 windows.  The
// work itself is ~9 fp32 operations a pair and the points read once.
//
// One block per (query tile, frame), kThreads threads (the steps in
// window_starts.cuh):
//  - the tile's queries, centred on its first, and their thresholds
//    (one scalar, or one a query: PER_QUERY) staged in shared memory;
//  - a thread a sampled row at a time: d2 against every staged query
//    (broadcast reads), the members counted in a register, the count kept
//    as 16 bits a row in shared memory;
//  - a thread's chunk of rows summed, the chunk sums scanned (warp
//    shuffles, then the warps' totals in order), each thread's window
//    positions walked with two running prefix sums, and the first best
//    window reduced over the warps and the block.
// Integer counts and sums: the same starts on every launch, no atomics.
// Launched on the current stream; allocates nothing, synchronises nothing.

#include <cuda_runtime.h>

#include "window_starts.cuh"

namespace {

using namespace window_starts;

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool PER_QUERY>
__global__ void __launch_bounds__(kThreads)
    window_starts_kernel(const float* __restrict__ q, const float* __restrict__ s, const float* __restrict__ thr_q,
                         float thr, int* __restrict__ starts, int M, int N, int tile, int stride, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  Query* qs = reinterpret_cast<Query*>(smem);
  unsigned short* cnt = reinterpret_cast<unsigned short*>(qs + tile);
  __shared__ int part[kThreads + 1];
  __shared__ int warp_sum[kWarps];
  __shared__ Best warp_best[kWarps];

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Geometry g = geometry(N, stride, width);
  const long q0 = static_cast<long>(b) * M + static_cast<long>(t) * tile;
  const float* qt = q + q0 * 3;
  const float rx = qt[0], ry = qt[1], rz = qt[2];
  for (int i = tid; i < tile; i += kThreads) qs[i] = centred(qt + 3 * i, rx, ry, rz, PER_QUERY ? thr_q[q0 + i] : thr);
  __syncthreads();

  const float* sb = s + static_cast<long>(b) * N * 3;
  for (int j = tid; j < g.n_sub; j += kThreads)
    cnt[j] = static_cast<unsigned short>(row_count(qs, tile, sb + static_cast<long>(j) * stride * 3, rx, ry, rz));
  __syncthreads();

  // exclusive scan of the chunk sums: within the warp, then the warps' totals
  const int own = chunk_sum(cnt, tid, g);
  int inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_sum[w];
      warp_sum[w] = acc;
      acc += v;
    }
    part[kThreads] = acc;
  }
  __syncthreads();
  part[tid] = warp_sum[warp] + inc - own;
  __syncthreads();

  Best best = chunk_best(cnt, part, tid, g);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Best other{__shfl_down_sync(kFull, best.v, o), __shfl_down_sync(kFull, best.i, o)};
    best = better(best, other);
  }
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) best = better(best, warp_best[w]);
    starts[static_cast<long>(b) * gridDim.x + t] = place(best, part[kThreads], t, tile, M, N, stride, g);
  }
}

int smem_bytes(int tile, int n_sub) {
  return tile * static_cast<int>(sizeof(Query)) + n_sub * static_cast<int>(sizeof(unsigned short));
}

template <bool PER_QUERY>
int launch(const float* q, const float* s, const float* thr_q, float thr, int* starts, int B, int M, int N,
           int tile, int stride, int width, cudaStream_t stream) {
  const int smem = smem_bytes(tile, geometry(N, stride, width).n_sub);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(window_starts_kernel<PER_QUERY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(M / tile, B);
  window_starts_kernel<PER_QUERY><<<grid, kThreads, smem, stream>>>(q, s, thr_q, thr, starts, M, N, tile, stride,
                                                                    width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, M, 3), s (B, N, 3) fp32 contiguous; thr_q (B, M) fp32, or null for
// the one threshold thr; starts (B, M / tile) int32.  M a multiple of tile,
// tile <= kMaxTile, ceil(N / stride) <= kMaxRows, B <= 65535.
extern "C" int window_starts_launch(const void* q, const void* s, const void* thr_q, float thr, void* starts,
                                    int B, int M, int N, int tile, int stride, int width, void* stream) {
  if (B < 1 || B > 65535 || M < 1 || N < 1 || tile < 1 || tile > kMaxTile || M % tile || stride < 1 ||
      width < 1 || geometry(N, stride, width).n_sub > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* sf = static_cast<const float*>(s);
  int* out = static_cast<int*>(starts);
  return thr_q != nullptr
             ? launch<true>(qf, sf, static_cast<const float*>(thr_q), thr, out, B, M, N, tile, stride, width, st)
             : launch<false>(qf, sf, nullptr, thr, out, B, M, N, tile, stride, width, st);
}
