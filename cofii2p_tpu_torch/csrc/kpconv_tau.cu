// Launchers of the k-NN (tau) KPConvs, kernels #7 (fused) and #6
// (aggregate), on the tensor-core kernel of kpconv_tau_mma.cuh: fp32
// compute by 3xTF32 (its builds in kpconv_tau_f32.cu), bf16 compute here.

#include "kpconv_tau_mma.cuh"

int cofii2p::tau_launch_bf16(const TauArgs& a) { return launch_tau_widths<false>(a); }

namespace {

// the active flags of the support rows, then the kernel of a's precision
// and widths; a width over 512, a band over N or a tile the block does not
// divide is refused before anything runs
int launch_tau(cofii2p::TauArgs& a, int round, void* active) {
  if (!cofii2p::tau_widths(a.Cin, a.Cout) || a.tile < 1 || a.band > a.N)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_active(a.st, a.f, a.f_bf16, a.B, a.N, a.Cin, static_cast<int*>(active));
  return round ? cofii2p::tau_launch_bf16(a) : cofii2p::tau_launch_f32(a);
}

}  // namespace

// q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, Cin) fp32 or bf16, kp (K, 3)
// fp32 (the layer's own kernel points), starts (B, num_tiles) int32, tau
// (B, M) fp32, active (B, N) int32 scratch; out (B, M, Cout) fp32
// unnormalised, count (B, M) int32.  W (K, CO, CI), padded to
// mma_pad(Cin), mma_pad(Cout): fp32 compute (round = 0)
// ops/kpconv_kernel.py::tf32_weights' fp32, bf16 compute mma_weights' bf16.
// r2 is the padded reach (tau_reach2).
extern "C" int kpconv_fused_tau_launch(
    const void* q, const void* s, const void* f, int f_bf16, const void* W,
    const void* kp, const void* starts, const void* tau, void* active,
    void* out, void* count, int B, int M, int N, int Cin, int Cout, int K,
    int tile, int num_tiles, int band, int round, float r2, float sigma,
    void* stream) {
  if (Cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  cofii2p::TauArgs a{static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16, W,
                     static_cast<const float*>(kp), static_cast<const int*>(starts), static_cast<const float*>(tau),
                     static_cast<const int*>(active), static_cast<float*>(out), static_cast<int*>(count),
                     B, M, N, Cin, Cout, K, tile, num_tiles, band, r2, sigma, static_cast<cudaStream_t>(stream)};
  return launch_tau(a, round, active);
}

// The aggregate: the arguments above without W and Cout; weighted
// (B, M, K, Cin) fp32.
extern "C" int kpconv_aggregate_tau_launch(
    const void* q, const void* s, const void* f, int f_bf16, const void* kp,
    const void* starts, const void* tau, void* active, void* weighted,
    void* count, int B, int M, int N, int Cin, int K, int tile, int num_tiles,
    int band, int round, float r2, float sigma, void* stream) {
  cofii2p::TauArgs a{static_cast<const float*>(q), static_cast<const float*>(s), f, f_bf16, nullptr,
                     static_cast<const float*>(kp), static_cast<const int*>(starts), static_cast<const float*>(tau),
                     static_cast<const int*>(active), static_cast<float*>(weighted), static_cast<int*>(count),
                     B, M, N, Cin, 0, K, tile, num_tiles, band, r2, sigma, static_cast<cudaStream_t>(stream)};
  return launch_tau(a, round, active);
}
