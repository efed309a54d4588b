// EPnP-RANSAC of the serving pipeline: a hypothesis kernel, and a
// refinement kernel in ten phases around the plain version's own sums.
//
// Replaces no TPU kernel: the JAX package's RANSAC (cofii2p_tpu/pose/
// ransac.py, epnp.py, ops/small_linalg.py) is plain jnp.  The port's plain
// version (pose/ransac.py::ransac_pnp_plain) unrolls the same small linear
// algebra into one PyTorch operation per scalar step: ~24k elementwise
// kernels in series, replayed as one CUDA graph at ~1.5 us a node, 30-39 ms
// a request for a few hundred MFLOP of work.  It was added because the stage
// is a launch chain, not because of its arithmetic.
//
// What bounds it on the H100: reading the (B, H, N) Gumbel noise once (21 MB
// at B = 8: ~6 us at 3.35 TB/s) and scoring's B*H*N reprojections at the
// CUDA cores' 67 TFLOP/s (~0.13 GFLOP at B = 8); the refinement is a chain
// of short launches over one frame each, bound by their latency.
//
// ransac_hyp_kernel: one warp per (frame, hypothesis), four warps a block.
// The lanes scan the masked Gumbel row (lane-strided, so a lane meets its
// indices in ascending order), each keeping its top 6, and six rounds of a
// warp max over (key, -index) merge them: value descending, lower index
// first on ties, NaN first, masked rows -inf -- the first six entries of the
// plain version's stable descending sort.  Every lane then solves the
// six-point EPnP itself (the same straight-line code in 32 lanes costs one
// warp's issue slots), M's 12 rows in registers and the 78 lower entries of
// M^T M summed from them, and the lanes count the inliers over all N with a
// warp reduction.  R, t, the count and the sample go to a scratch buffer.
//
// ransac_refine_kernel<PHASE>: the refinement, one block of 256 threads per
// frame, in ten phases (ransac_pnp.cuh): the best count over H (torch's
// argmax tie rule), then per round the inlier weights (the mask where fewer
// than 4 inliers), the control points' frame and M, the eigenvectors and
// both cases' camera points, the alignment moments, both alignments and
// their errors, the pick and 5 Gauss-Newton steps; then the final inliers.
// Between phases the plain version's own PyTorch calls take the sums over
// the N points (pose/ransac.py::run_kernels): cuBLAS and PyTorch's
// reduction kernel sum over N in orders that change with the batch count
// (split-K at B = 1), and the plain version's refinement is chaotic on
// junk correspondences, so a sum in any other order changes the inlier
// count of some frames.  Per-point work is spread over the threads; the
// 3 x 3, 4 x 4, 6 x 6 and 12 x 12 work runs in every thread alike.
//
// Arithmetic: ransac_pnp.cuh, the plain version's formulas operation for
// operation in fp32, each short product in the order cuBLAS takes for the
// plain version's call at that batch count (Orders, found at run time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ransac_pnp.cuh"

namespace {

using namespace ransac;

constexpr int kHypWarps = 4;
constexpr int kRefineThreads = 256;
constexpr int kRefineWarps = kRefineThreads / 32;
constexpr unsigned kNegInfKey = 0x007fffffu;  // order_key(-inf)

// torch.sort's descending order as an unsigned key: NaN first, -0 ties +0
__device__ __forceinline__ unsigned order_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  if (x == 0.f) x = 0.f;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One warp per (frame, hypothesis): the sample, its EPnP pose and its count.
__global__ void __launch_bounds__(kHypWarps * 32) ransac_hyp_kernel(
    const float* __restrict__ gumbel, const float* __restrict__ obj, const float* __restrict__ img,
    const float* __restrict__ Kmat, const float* __restrict__ mask, int B, int H, int N, float thr, Orders o,
    int* __restrict__ samples, float* __restrict__ hypR, float* __restrict__ hypt, int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long gh = static_cast<long>(blockIdx.x) * kHypWarps + (threadIdx.x >> 5);
  if (gh >= static_cast<long>(B) * H) return;
  const long b = gh / H;
  const float* g = gumbel + gh * N;
  const float* m = mask + b * N;
  const float* P = obj + b * N * 3;
  const float* uv = img + b * N * 2;

  // this lane's top six, in its ascending indices: a tie stays behind
  unsigned key[kSample];
  int idx[kSample];
#pragma unroll
  for (int j = 0; j < kSample; ++j) {
    key[j] = 0u;
    idx[j] = 0x7fffffff;
  }
  for (int n = lane; n < N; n += 32) {
    const unsigned k = m[n] > 0.f ? order_key(g[n]) : kNegInfKey;
    if (k > key[kSample - 1]) {
      key[kSample - 1] = k;
      idx[kSample - 1] = n;
#pragma unroll
      for (int j = kSample - 1; j > 0; --j)
        if (key[j] > key[j - 1]) {
          const unsigned tk = key[j];
          key[j] = key[j - 1];
          key[j - 1] = tk;
          const int ti = idx[j];
          idx[j] = idx[j - 1];
          idx[j - 1] = ti;
        }
    }
  }
  // six rounds of a warp max over (key, lower index)
  Six s;
#pragma unroll
  for (int r = 0; r < kSample; ++r) {
    unsigned long long c = (static_cast<unsigned long long>(key[0]) << 32) | static_cast<unsigned>(~idx[0]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, c, off);
      c = other > c ? other : c;
    }
    const int win = static_cast<int>(~static_cast<unsigned>(c));
    if (idx[0] == win) {
#pragma unroll
      for (int j = 0; j < kSample - 1; ++j) {
        key[j] = key[j + 1];
        idx[j] = idx[j + 1];
      }
      key[kSample - 1] = 0u;
      idx[kSample - 1] = 0x7fffffff;
    }
    if (lane == 0) samples[gh * kSample + r] = win;
    load_point(P, uv, win, s.p[r], s.u[r], s.v[r]);
  }

  F Km[9], R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Km[k] = F(Kmat[b * 9 + k]);
  epnp_six(s, Km, o, R, t);

  int count = 0;
  for (int n = lane; n < N; n += 32) {
    F p[3], u, v;
    load_point(P, uv, n, p, u, v);
    const F err = reproj_err(R, t, p, u, v, Km, o.m[kPRN], o.m[kCamKN]);
    count += (err.v < thr) && (m[n] > 0.f);
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) {
    counts[gh] = count;
#pragma unroll
    for (int k = 0; k < 9; ++k) hypR[gh * 9 + k] = R[k].v;
#pragma unroll
    for (int k = 0; k < 3; ++k) hypt[gh * 3 + k] = t[k].v;
  }
}

// A frame's sums over its threads: a shuffle-down tree in each warp, the
// warps' sums in warp order (the same bits on every launch).
struct Red {
  float part[kRefineWarps];
  int count[kRefineWarps];
};

// The refinement's policy on the card: a frame a block, a thread's points
// every kRefineThreads-th from its index.
struct CudaBlock {
  Red& red;
  __device__ int first() const { return threadIdx.x; }
  __device__ int step() const { return kRefineThreads; }
  __device__ int frames() const { return gridDim.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ int count(int c) {
    c = __reduce_add_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0) red.count[threadIdx.x >> 5] = c;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kRefineWarps; ++w) total += red.count[w];
    __syncthreads();
    return total;
  }
  __device__ F sum(F v) {
    float x = v.v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    if ((threadIdx.x & 31) == 0) red.part[threadIdx.x >> 5] = x;
    __syncthreads();
    F total = F(red.part[0]);
#pragma unroll
    for (int w = 1; w < kRefineWarps; ++w) total = total + F(red.part[w]);
    __syncthreads();
    return total;
  }
};


template <int PHASE>
__global__ void __launch_bounds__(kRefineThreads) ransac_refine_kernel(Bufs q, Orders o, int more) {
  __shared__ Red red;
  CudaBlock blk{red};
  const long b = blockIdx.x;
  if constexpr (PHASE == kBest) {
    if (threadIdx.x == 0) phase_best(q, b);
  } else if constexpr (PHASE == kWeights) {
    phase_weights(q, o, blk, b);
  } else if constexpr (PHASE == kCentre) {
    phase_centre(q, blk, b);
  } else if constexpr (PHASE == kFrame) {
    phase_frame(q, o, blk, b);
  } else if constexpr (PHASE == kEig) {
    phase_eig(q, o, blk, b);
  } else if constexpr (PHASE == kMoments) {
    phase_moments(q, blk, b);
  } else if constexpr (PHASE == kRigid) {
    phase_rigid(q, o, blk, b);
  } else if constexpr (PHASE == kPick) {
    phase_pick(q, o, blk, b);
  } else if constexpr (PHASE == kGaussNewton) {
    phase_gauss_newton(q, o, blk, b, more);
  } else {
    phase_final(q, o, blk, b);
  }
}

template <int PHASE>
cudaError_t launch_phase(const Bufs& q, const Orders& o, int B, int more, cudaStream_t st) {
  ransac_refine_kernel<PHASE><<<B, kRefineThreads, 0, st>>>(q, o, more);
  return cudaGetLastError();
}


}  // namespace

// The hypothesis stage: samples (B, H, 6) int32, hypR (B, H, 9), hypt
// (B, H, 3), counts (B, H) int32; sample_size must be 6; orders: kSites
// ints on the host, the short products' orders at batch count B * H.
extern "C" int ransac_hyp_launch(const void* gumbel, const void* obj, const void* img, const void* K,
                                 const void* mask, int B, int H, int N, int sample_size, float thr,
                                 const int* orders, void* samples, void* hypR, void* hypt, void* counts,
                                 void* stream) {
  if (sample_size != kSample || N < kSample || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long warps = static_cast<long>(B) * H;
  const unsigned blocks = static_cast<unsigned>((warps + kHypWarps - 1) / kHypWarps);
  ransac_hyp_kernel<<<blocks, kHypWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gumbel), static_cast<const float*>(obj), static_cast<const float*>(img),
      static_cast<const float*>(K), static_cast<const float*>(mask), B, H, N, thr, read_orders(orders),
      static_cast<int*>(samples), static_cast<float*>(hypR), static_cast<float*>(hypt), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// One phase of the refinement over B frames; ptrs: kPtrs device pointers
// in the order of enum Ptr, on the host; orders: the short products' orders
// at batch count B; more: whether a Gauss-Newton step writes the next
// step's terms.
extern "C" int ransac_refine_launch(int phase, const long long* ptrs, const int* orders, int B, int H, int N,
                                    float thr, int more, void* stream) {
  if (B < 1 || H < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Bufs q = unpack(ptrs, H, N, thr);
  const Orders o = read_orders(orders);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (phase) {
    case kBest: err = launch_phase<kBest>(q, o, B, more, st); break;
    case kWeights: err = launch_phase<kWeights>(q, o, B, more, st); break;
    case kCentre: err = launch_phase<kCentre>(q, o, B, more, st); break;
    case kFrame: err = launch_phase<kFrame>(q, o, B, more, st); break;
    case kEig: err = launch_phase<kEig>(q, o, B, more, st); break;
    case kMoments: err = launch_phase<kMoments>(q, o, B, more, st); break;
    case kRigid: err = launch_phase<kRigid>(q, o, B, more, st); break;
    case kPick: err = launch_phase<kPick>(q, o, B, more, st); break;
    case kGaussNewton: err = launch_phase<kGaussNewton>(q, o, B, more, st); break;
    case kFinal: err = launch_phase<kFinal>(q, o, B, more, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
