// Launcher of kernel #2, the banded aggregate of the training forward: the
// tensor-core KPConv of kpconv_tau_mma.cuh under radius membership, with
// no contraction, in fp32 by 3xTF32 and in bf16, at every padded Cin.  A
// source of its own, so that nvcc compiles these builds in a process
// beside the tau kernels' (kpconv_tau.cu, kpconv_tau_f32.cu).

#include "kpconv_tau_mma.cuh"

int cofii2p::radius_launch(const TauArgs& a, int round) {
  return round ? launch_radius_widths<false>(a) : launch_radius_widths<true>(a);
}

// q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, Cin) fp32 or bf16, kp (K, 3)
// fp32 (the canonical kernel points), starts (B, num_tiles) int32 static
// band starts or the caller's window starts of width band; weighted
// (B, M, K, Cin) fp32, count (B, M) int32 = max(#in-reach band rows, 1).
// r2 is the squared kernel reach.  bf16 compute (round = 1) rounds the
// influence and the features to bf16 before their product.  The block
// takes its TauPlan's queries; Cin over 512 or a band over N is refused
// before anything runs.
extern "C" int kpconv_aggregate_launch(
    const void* q, const void* s, const void* f, int f_bf16, const void* kp,
    const void* starts, void* weighted, void* count, int B, int M, int N,
    int Cin, int K, int tile, int num_tiles, int band, int round, float r2,
    float sigma, void* stream) {
  if (!cofii2p::tau_widths(Cin, 0) || tile < 1 || band > N) return static_cast<int>(cudaErrorInvalidValue);
  cofii2p::TauArgs a{static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16, nullptr,
                     static_cast<const float*>(kp), static_cast<const int*>(starts), nullptr, nullptr,
                     static_cast<float*>(weighted), static_cast<int*>(count),
                     B, M, N, Cin, 0, K, tile, num_tiles, band, r2, sigma, static_cast<cudaStream_t>(stream)};
  return cofii2p::radius_launch(a, round);
}
