// The transposed banded KPConv aggregation's launchers.  All three run the
// tensor-core kernel of kpconv_transpose_mma.cuh (fp32 by 3xTF32 with
// round = 0, bf16 with round = 1) and hold no kernel of their own:
//  - kpconv_transpose_launch: kernel #9, static bands, radius membership
//    (RadiusMember); replaces cofii2p_tpu/ops/kpconv_kernel.py::_transpose_agg;
//  - kpconv_transpose_dyn_launch: kernel #10, dynamic windows, radius
//    membership, the kernel's WINDOW mode writing a per-tile stack that
//    band_scatter.cu adds up; replaces _transpose_agg_dyn;
//  - kpconv_transpose_tau_launch: kernel #11, static bands, k-NN membership
//    (TauMember) and the layer's own kernel points; replaces
//    _transpose_agg_tau.
// The kernel's header says what bounds it on the H100 and how its plan
// meets that; no atomics, the same bits on every launch.

#include "kpconv_transpose_mma.cuh"

namespace {

cofii2p::TransposeArgs transpose_args(const void* q, const void* s, const void* g, const void* kp,
                                      const void* starts, const void* qstart_blk, const void* tau, void* out, int B,
                                      int M, int N, int C, int K, int tile, int num_tiles, int band, int TS,
                                      int n_qtiles, float r2, float sigma, void* stream) {
  return cofii2p::TransposeArgs{static_cast<const float*>(q), static_cast<const float*>(s),
                                static_cast<const float*>(g), static_cast<const float*>(kp),
                                static_cast<const int*>(starts), static_cast<const int*>(qstart_blk),
                                static_cast<const float*>(tau), static_cast<float*>(out),
                                B, M, N, C, K, tile, num_tiles, band, TS, n_qtiles, r2, sigma,
                                static_cast<cudaStream_t>(stream)};
}

template <bool WINDOW, class Member>
int launch(const cofii2p::TransposeArgs& a, const Member& member, int round) {
  return round ? launch_transpose_widths<false, WINDOW>(a, member) : launch_transpose_widths<true, WINDOW>(a, member);
}

}  // namespace

// Kernel #9: q (B, M, 3), s (B, N, 3), g (B, M, K, C) fp32, kp (K, 3) fp32
// the shared kernel points, starts (B, num_tiles) int32 static band
// starts, qstart_blk (N / TS) int32 first query tile of each support
// tile's window of n_qtiles tiles; out (B, N, C) fp32.  r2 the squared
// kernel reach.  TS divides N, TS <= 64 (TransposePlan), tile <= 128,
// C <= 512.
extern "C" int kpconv_transpose_launch(
    const void* q, const void* s, const void* g, const void* kp,
    const void* starts, const void* qstart_blk, void* out, int B, int M,
    int N, int C, int K, int tile, int num_tiles, int band, int TS,
    int n_qtiles, int round, float r2, float sigma, void* stream) {
  const auto a = transpose_args(q, s, g, kp, starts, qstart_blk, nullptr, out, B, M, N, C, K, tile, num_tiles, band,
                                TS, n_qtiles, r2, sigma, stream);
  return launch<false>(a, RadiusMember{}, round);
}

// Kernel #10's stack: q, s, g, kp as above, starts (B, num_tiles) int32
// dynamic window starts of width band, each in [0, N - band]; stack
// (B, num_tiles, band, C) fp32, each tile's window rows' gradient
// (band_scatter.cu adds them up).  TS divides band, TS <= 64.
extern "C" int kpconv_transpose_dyn_launch(
    const void* q, const void* s, const void* g, const void* kp,
    const void* starts, void* stack, int B, int M, int N, int C, int K,
    int tile, int num_tiles, int band, int TS, int round, float r2,
    float sigma, void* stream) {
  const auto a = transpose_args(q, s, g, kp, starts, nullptr, nullptr, stack, B, M, N, C, K, tile, num_tiles, band,
                                TS, 1, r2, sigma, stream);
  return launch<true>(a, RadiusMember{}, round);
}

// Kernel #11: as kpconv_transpose_launch with tau (B, M) fp32 the
// per-query squared k-NN thresholds, kp the layer's own kernel points and
// r2 the padded reach.
extern "C" int kpconv_transpose_tau_launch(
    const void* q, const void* s, const void* g, const void* kp,
    const void* starts, const void* qstart_blk, const void* tau, void* out,
    int B, int M, int N, int C, int K, int tile, int num_tiles, int band,
    int TS, int n_qtiles, int round, float r2, float sigma, void* stream) {
  const auto a = transpose_args(q, s, g, kp, starts, qstart_blk, tau, out, B, M, N, C, K, tile, num_tiles, band, TS,
                                n_qtiles, r2, sigma, stream);
  return launch<false>(a, TauMember{static_cast<const float*>(tau)}, round);
}
