// The strided ResidualBlock's fused band pass for Hopper (kernel #16).
//
// Replaces: cofii2p_tpu/ops/residual_kernel.py::banded_residual_fused_pallas
// (body _res_kernel_recompute).  For each query m of the strided level:
//   conv[m, :]     = sum_k ( sum_j infl_k(q_m, s_j) a_j ) @ W_k,
//   count[m]       = max(#in-reach band rows, 1),
//   shortcut[m, c] = max_j f_j[c], 0 where no band row is in reach,
// over the band rows j of m's 128-query tile with d2 <= kernel reach^2;
// a = unary1(x) (Cmid channels), f = the block input x (Cin channels).
// conv and count are #1's (csrc/kpconv_fused.cu), shortcut is #3's
// (csrc/maxpool_fwd.cu), on the same inputs.
//
// What bounds it on the H100: the conv half, as #1 (the influence math
// over the band and the two products on the tensor cores); the shortcut
// reads each in-reach feature row once per query, as #3.  The TPU kernel
// fused the pair to share the band DMA and d2 between a (tile, band chunk)
// grid and its channel chunks.  Here the block of #1 runs #1's tensor-core
// kernel (kpconv_mma.cuh) in POOL mode, in both precisions (bf16 compute
// here, fp32 by 3xTF32 in residual_fused_f32.cu): the ballots that build
// its active-row list and counts are kept as per-query bitmasks in shared
// memory, and the same block walks their set bits over the Cin-channel
// features for the max before its K-sweep.  Each band row's membership is
// computed once for both halves.
//
// Exactness: the conv half is #1's code at #1's plan, so conv and count are
// bit-equal to #1's; the shortcut is a select over the same membership
// (centred, FMA-free d2 of common.cuh), bit-equal to #3 and to the plain
// version in fp32 and in bf16.

#include "kpconv_mma.cuh"

// q (B, M, 3) fp32, s (B, N, 3) fp32, a (B, N, Cmid) and f (B, N, Cin)
// fp32 or bf16, kp (K, 3) fp32, starts (B, num_tiles) int32; out
// (B, M, Dout) fp32, count (B, M) int32, shortcut (B, M, Cin) in f's
// dtype.  W as kpconv_fused_launch takes it for (Cmid, Dout): bf16 compute
// (round = 1) mma_weights' bf16, fp32 compute tf32_weights' fp32; the
// block takes #1's MmaPlan queries.
extern "C" int residual_fused_launch(
    const void* q, const void* s, const void* a, int a_bf16, const void* f,
    int f_bf16, const void* W, const void* kp, const void* starts, void* out,
    void* count, void* shortcut, int B, int M, int N, int Cmid, int Dout,
    int Cin, int K, int tile, int num_tiles, int band, int round, float r2,
    float sigma, void* stream) {
  const cofii2p::FusedArgs args{static_cast<const float*>(q), static_cast<const float*>(s), a, a_bf16, W,
                                static_cast<const float*>(kp), static_cast<const int*>(starts),
                                static_cast<float*>(out), static_cast<int*>(count), B, M, N, Cmid, Dout, K, tile,
                                num_tiles, band, r2, sigma, static_cast<cudaStream_t>(stream), f, f_bf16, Cin,
                                shortcut};
  return round ? launch_mma_widths<true, false>(args) : cofii2p::residual_launch_f32(args);
}
