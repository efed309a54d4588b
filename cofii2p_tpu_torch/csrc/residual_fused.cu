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
// (csrc/maxpool.cu), on the same inputs.
//
// What bounds it on the H100: the conv half, as #1 (the influence math
// over the band and the CUDA-core contraction); the shortcut reads each
// in-reach feature row once per query, as #3.  The TPU kernel fused the
// pair to share the band DMA and d2 between a (tile, band chunk) grid and
// its channel chunks.  Here the block of #1 (TQ queries of one band tile)
// runs the kpconv_fused.cuh kernel in POOL mode: the ballots that build its
// active-row list and counts are kept as per-query bitmasks in shared
// memory, and the same block walks their set bits over the Cin-channel
// features for the max before its K-sweep (see kpconv_fused.cuh).  Each
// band row's membership is computed once for both halves.  In bf16 the
// conv half is #1's tensor-core kernel in the same POOL mode
// (kpconv_mma.cuh); fp32 stays on the CUDA-core template, as #1 does.
//
// Exactness: the conv half is #1's code at #1's TQ, so conv and count are
// bit-equal to #1's; the shortcut is a select over the same membership
// (centred, FMA-free d2 of common.cuh), bit-equal to #3 and to the plain
// version in fp32 and in bf16.

#include "kpconv_mma.cuh"

// q (B, M, 3) fp32, s (B, N, 3) fp32, a (B, N, Cmid) and f (B, N, Cin)
// fp32 or bf16, kp (K, 3) fp32, starts (B, num_tiles) int32; out
// (B, M, Dout) fp32, count (B, M) int32, shortcut (B, M, Cin) in f's
// dtype.  W and TQ as kpconv_fused_launch takes them for (Cmid, Dout):
// bf16 compute runs the tensor-core kernel with mma_weights' bf16 W at its
// MmaPlan's queries (TQ is not read); fp32 compute W (K, Cmid, Dout) fp32,
// TQ <= 128, TQ * pad(Cmid) and TQ * pad(Dout) <= 8192, TQ divides tile.
extern "C" int residual_fused_launch(
    const void* q, const void* s, const void* a, int a_bf16, const void* f,
    int f_bf16, const void* W, const void* kp, const void* starts, void* out,
    void* count, void* shortcut, int B, int M, int N, int Cmid, int Dout,
    int Cin, int K, int tile, int num_tiles, int band, int TQ, int round,
    float r2, float sigma, void* stream) {
  if (round && cofii2p::mma_widths(Cmid, Dout))
    return launch_mma_widths<true>(B, static_cast<cudaStream_t>(stream), static_cast<const float*>(q),
                                   static_cast<const float*>(s), a, a_bf16, W, static_cast<const float*>(kp),
                                   static_cast<const int*>(starts), static_cast<float*>(out),
                                   static_cast<int*>(count), M, N, Cmid, Dout, K, tile, num_tiles, band, r2, sigma,
                                   f, f_bf16, Cin, shortcut);
  const int cs = log2_pad(Cmid), os = log2_pad(Dout);
  const int A = cs < 8 ? 0 : 1 << (cs - 8);
  const int AO = os < 8 ? 0 : 1 << (os - 8);
  if (A > 2 || AO > 2 || Cin < 1 || TQ < 1 || TQ > kMaxTQ || tile % TQ ||
      M % TQ || (TQ << cs) > kAccElems || (TQ << os) > kAccElems || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M / TQ, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto sp = static_cast<const float*>(s);
  auto wp = static_cast<const float*>(W);
  auto kpp = static_cast<const float*>(kp);
  auto stp = static_cast<const int*>(starts);
  auto op = static_cast<float*>(out);
  auto cp = static_cast<int*>(count);
#define COFII2P_LAUNCH(a_, ao)                                                   \
  if (A == a_ && AO == ao)                                                       \
    launch<a_, ao, true, true>(grid, st, qp, sp, a, a_bf16, wp, kpp, stp, op,   \
                               cp, M, N, Cmid, Dout, K, tile, num_tiles, band,   \
                               TQ, cs, os, r2, sigma, round, f, f_bf16, Cin,     \
                               shortcut);
  COFII2P_LAUNCH(0, 0)
  COFII2P_LAUNCH(0, 1)
  COFII2P_LAUNCH(0, 2)
  COFII2P_LAUNCH(1, 0)
  COFII2P_LAUNCH(1, 1)
  COFII2P_LAUNCH(1, 2)
  COFII2P_LAUNCH(2, 0)
  COFII2P_LAUNCH(2, 1)
  COFII2P_LAUNCH(2, 2)
#undef COFII2P_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
