// The scatter of the dynamic-window backward passes (kernels #10 and #14)
// for Hopper: per-tile window gradients back to the support rows.
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::_scatter_band_stacks, the XLA
// loop that follows _agg_bwd_dyn_kernel and _mp_bwd_dyn_kernel.  Same
// function: out[b, n, c] = sum over tiles t = 0 .. nt-1, in that order, of
// stack[b, t, n - starts[b, t], c] where starts[b, t] <= n < starts[b, t] +
// band.
//
// One thread per (b, n, c) walks the tiles in order and adds the rows whose
// window holds n, so the sum runs in the TPU's order and the result is
// bit-equal to the plain version (ops/banded.py::scatter_band_stacks) on the
// same stack.  No atomics.  What bounds it: reading the stack once and
// writing out once; the tile walk reads the starts from shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 4096;

__global__ void __launch_bounds__(kThreads) band_scatter_kernel(
    const float* __restrict__ stack, const int* __restrict__ starts,
    float* __restrict__ out, int N, int C, int nt, int band) {
  __shared__ int st_s[kMaxTiles];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < nt; i += kThreads) st_s[i] = starts[b * nt + i];
  __syncthreads();
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;  // n * C + c
  if (idx >= (long)N * C) return;
  const int n = static_cast<int>(idx / C), c = static_cast<int>(idx % C);
  float acc = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int j = n - st_s[t];
    if (j >= 0 && j < band) acc = __fadd_rn(acc, stack[(((long)b * nt + t) * band + j) * C + c]);
  }
  out[(long)b * N * C + idx] = acc;
}

}  // namespace

// stack (B, nt, band, C) fp32, starts (B, nt) int32 in [0, N - band];
// out (B, N, C) fp32.  nt <= 4096.
extern "C" int band_scatter_launch(const void* stack, const void* starts,
                                   void* out, int B, int N, int C, int nt,
                                   int band, void* stream) {
  if (nt < 1 || nt > kMaxTiles || band < 1 || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const long total = (long)N * C;
  dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads), B);
  band_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stack), static_cast<const int*>(starts),
      static_cast<float*>(out), N, C, nt, band);
  return static_cast<int>(cudaGetLastError());
}
