// Launcher of the banded KPConv kernel #1 (fused): fp32 on the CUDA-core
// template (kpconv_fused.cuh), bf16 on the tensor cores (kpconv_mma.cuh).
// The aggregate, #2, is launched from kpconv_aggregate.cu, the k-NN
// variants, #7 and #6, from kpconv_tau.cu.

#include "kpconv_mma.cuh"

// q (B, M, 3) fp32, s (B, N, 3) fp32, f (B, N, Cin) fp32 or bf16,
// kp (K, 3) fp32, starts (B, num_tiles) int32; out (B, M, Cout) fp32,
// count (B, M) int32.  bf16 compute (round), Cin and Cout <= 512, runs the
// tensor-core kernel: W is then ops/kpconv_kernel.py::mma_weights' (K, CO,
// CI) bf16, and the block takes its MmaPlan's queries (TQ is not read).
// fp32 compute runs the CUDA-core template: W (K, Cin, Cout) fp32, TQ <=
// 128, TQ * pad(Cin) and TQ * pad(Cout) <= 8192, TQ divides tile.
extern "C" int kpconv_fused_launch(
    const void* q, const void* s, const void* f, int f_bf16, const void* W,
    const void* kp, const void* starts, void* out, void* count, int B, int M,
    int N, int Cin, int Cout, int K, int tile, int num_tiles, int band, int TQ,
    int round, float r2, float sigma, void* stream) {
  if (round && cofii2p::mma_widths(Cin, Cout))
    return launch_mma_widths<false>(B, static_cast<cudaStream_t>(stream), static_cast<const float*>(q),
                                    static_cast<const float*>(s), f, f_bf16, W, static_cast<const float*>(kp),
                                    static_cast<const int*>(starts), static_cast<float*>(out),
                                    static_cast<int*>(count), M, N, Cin, Cout, K, tile, num_tiles, band, r2, sigma);
  const int cs = log2_pad(Cin), os = log2_pad(Cout);
  const int A = cs < 8 ? 0 : 1 << (cs - 8);
  const int AO = os < 8 ? 0 : 1 << (os - 8);
  if (A > 2 || AO > 2 || TQ < 1 || TQ > kMaxTQ || tile % TQ || M % TQ ||
      (TQ << cs) > kAccElems || (TQ << os) > kAccElems || band > N)
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
#define COFII2P_LAUNCH(a, ao)                                                   \
  if (A == a && AO == ao)                                                       \
    launch<a, ao>(grid, st, qp, sp, f, f_bf16, wp, kpp, stp, op, cp, M, N, Cin, \
                  Cout, K, tile, num_tiles, band, TQ, cs, os, r2, sigma, round);
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
