// Launcher of the banded KPConv kernel #1 (fused) on the tensor cores
// (kpconv_mma.cuh): bf16 compute here, fp32 by 3xTF32 in
// kpconv_fused_f32.cu, a source of its own so that nvcc builds it in a
// process beside this one.  The aggregate, #2, is launched from
// kpconv_aggregate.cu, the k-NN variants, #7 and #6, from kpconv_tau.cu.

#include "kpconv_mma.cuh"

// q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, Cin) fp32 or bf16, kp (K, 3)
// fp32, starts (B, num_tiles) int32; out (B, M, Cout) fp32, count (B, M)
// int32.  Cin and Cout <= 512.  W (K, CO, CI), padded to mma_pad(Cin),
// mma_pad(Cout): bf16 compute (round = 1) ops/kpconv_kernel.py::mma_weights'
// bf16, fp32 compute (round = 0) tf32_weights' fp32.  The block takes its
// MmaPlan's queries.
extern "C" int kpconv_fused_launch(
    const void* q, const void* s, const void* f, int f_bf16, const void* W,
    const void* kp, const void* starts, void* out, void* count, int B, int M,
    int N, int Cin, int Cout, int K, int tile, int num_tiles, int band,
    int round, float r2, float sigma, void* stream) {
  const cofii2p::FusedArgs a{static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16, W,
                             static_cast<const float*>(kp), static_cast<const int*>(starts), static_cast<float*>(out),
                             static_cast<int*>(count), B, M, N, Cin, Cout, K, tile, num_tiles, band, r2, sigma,
                             static_cast<cudaStream_t>(stream), nullptr, 0, 0, nullptr};
  return round ? launch_mma_widths<false, false>(a) : cofii2p::fused_launch_f32(a);
}
