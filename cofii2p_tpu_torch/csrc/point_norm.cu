// The point branch's GroupNorm chain for Hopper: per (frame, group)
// statistics over all N points and the group's channels, then
// ((x - mean) * rstd) * weight + bias in x's dtype, optionally plus a
// residual and optionally LeakyReLU(0.1), in three kernels.
//
// Replaces no TPU kernel: cofii2p_tpu/models/layers.py's PointGroupNorm and
// leaky_relu are plain jnp, which XLA fuses on the TPU.  PyTorch runs the
// same chain as ~10 passes a site (a cast, two reductions with B * G outputs,
// four fp32 broadcast passes, a cast back, three for the LeakyReLU, one for
// the residual add): ~33 GB a bf16 B = 8 forward over the FPN's 47 sites.
// The chain itself needs x read once, the residual read once and the
// output written once; this design reads x a second time (statistics, then
// apply).  What bounds it: those bytes at 3.35 TB/s.
//
// point_norm_stats_kernel: grid (row chunk, frame, slice), block plan
// point_norm_plan.cuh.  A thread reads 16 bytes of a row at a time down its
// vector column and sums (x - K) and (x - K)^2 per group in fp32, K the
// group's first channel in the chunk's first row (a shift that keeps the
// sums from cancelling).  The block adds its threads' sums in a fixed order
// and writes each group's (mean, M2) for the chunk.
//
// point_norm_merge_kernel: grid (frame, slice); merges the chunks' partials
// in chunk order by the pooled form of Chan's formula (mean = sum n_c m_c /
// n, M2 = sum M2_c + n_c (m_c - mean)^2) and writes mean and rstd =
// rsqrt(M2 / n + eps) (biased variance).  No atomics: every sum runs in an
// order fixed by the shape, so two launches give the same bits.
//
// point_norm_apply_kernel: the same block plan over its own row chunks;
// each thread keeps its channels' weight, bias, mean and rstd in registers
// and streams rows.  Each operation rounds in fp32 in the plain version's
// order (ops/norm_kernel.py::group_norm_apply_plain): __fsub_rn,
// __fmul_rn, __fmul_rn, __fadd_rn, no contraction; the result rounds to x's
// dtype; the residual is added to that in fp32 and rounded again, as
// PyTorch's add; LeakyReLU keeps x >= 0 and rounds 0.1f * x otherwise.
// Given the same mean and rstd, its output is bit-equal to the plain
// version's.

#include <stdint.h>

#include "common.cuh"
#include "point_norm_plan.cuh"

namespace {

using point_norm::kThreads;
using point_norm::Plan;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float x) { return x; }
  __device__ static float scalar(const float* p) { return *p; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float x) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  // f holds values already rounded to bf16
  __device__ static uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | (bits(f[1]) << 16), bits(f[2]) | (bits(f[3]) << 16),
                      bits(f[4]) | (bits(f[5]) << 16), bits(f[6]) | (bits(f[7]) << 16));
  }
  __device__ static float round(float x) { return cofii2p::round_bf16(x); }
  __device__ static float scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};

template <typename T>
__device__ __forceinline__ uint4 load_row(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the sums of one vector into its groups' accumulators
template <typename T, int GPV>
__device__ __forceinline__ void accumulate(const uint4& u, const float* K, float* s1, float* s2) {
  constexpr int VEC = Pack<T>::kVec;
  float f[VEC];
  Pack<T>::unpack(u, f);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int j = GPV > 1 ? e / (VEC / GPV) : 0;
    const float d = __fsub_rn(f[e], K[j]);
    s1[j] = __fadd_rn(s1[j], d);
    s2[j] = __fmaf_rn(d, d, s2[j]);
  }
}

template <typename T, int GPV>
__global__ void __launch_bounds__(kThreads) point_norm_stats_kernel(
    const T* __restrict__ x, float2* __restrict__ part, int N, int C, Plan p, int rows, int nchunks) {
  constexpr int VEC = Pack<T>::kVec;
  __shared__ float sh1[GPV * kThreads], sh2[GPV * kThreads];
  const int chunk = blockIdx.x, b = blockIdx.y, slice = blockIdx.z, slices = gridDim.z;
  const int t = threadIdx.x, col = t % p.cs, ry = t / p.cs;
  const int v = slice * p.cs + col;  // the thread's vector column
  const int r0 = chunk * rows, r1 = min(N, r0 + rows);
  const T* xb = x + static_cast<long>(b) * N * C;

  float K[GPV], s1[GPV], s2[GPV];
#pragma unroll
  for (int j = 0; j < GPV; ++j) {
    const int g = GPV > 1 ? v * GPV + j : (v * VEC) / p.cg;
    K[j] = Pack<T>::scalar(xb + static_cast<long>(r0) * C + g * p.cg);
    s1[j] = 0.f;
    s2[j] = 0.f;
  }
  const T* xc = xb + v * VEC;
  int r = r0 + ry;
  for (; r + 3 * p.ry < r1; r += 4 * p.ry) {
    const uint4 u0 = load_row(xc + static_cast<long>(r) * C);
    const uint4 u1 = load_row(xc + static_cast<long>(r + p.ry) * C);
    const uint4 u2 = load_row(xc + static_cast<long>(r + 2 * p.ry) * C);
    const uint4 u3 = load_row(xc + static_cast<long>(r + 3 * p.ry) * C);
    accumulate<T, GPV>(u0, K, s1, s2);
    accumulate<T, GPV>(u1, K, s1, s2);
    accumulate<T, GPV>(u2, K, s1, s2);
    accumulate<T, GPV>(u3, K, s1, s2);
  }
  for (; r < r1; r += p.ry) accumulate<T, GPV>(load_row(xc + static_cast<long>(r) * C), K, s1, s2);

#pragma unroll
  for (int j = 0; j < GPV; ++j) {
    sh1[j * kThreads + t] = s1[j];
    sh2[j * kThreads + t] = s2[j];
  }
  __syncthreads();
  // the slice's group gl has tpg * GPV member sums: thread (gl, q) adds
  // members [q * GPV, q * GPV + GPV) in order, thread (gl, 0) the tpg results
  const int tpg = kThreads / p.gs, gl = t / tpg, q = t % tpg;
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int i = 0; i < GPV; ++i) {
    const int m = q * GPV + i;
    const int idx = GPV > 1 ? (gl % GPV) * kThreads + m * p.cs + gl / GPV
                            : (m / p.cpg) * p.cs + gl * p.cpg + m % p.cpg;
    a1 = __fadd_rn(a1, sh1[idx]);
    a2 = __fadd_rn(a2, sh2[idx]);
  }
  __syncthreads();
  sh1[t] = a1;
  sh2[t] = a2;
  __syncthreads();
  if (q == 0) {
    float S1 = 0.f, S2 = 0.f;
    for (int i = 0; i < tpg; ++i) {
      S1 = __fadd_rn(S1, sh1[t + i]);
      S2 = __fadd_rn(S2, sh2[t + i]);
    }
    const int g = slice * p.gs + gl;
    const float Kg = Pack<T>::scalar(xb + static_cast<long>(r0) * C + g * p.cg);
    const float n = static_cast<float>((r1 - r0) * p.cg);
    const float d = __fdiv_rn(S1, n);
    const float m2 = fmaxf(__fsub_rn(S2, __fmul_rn(S1, d)), 0.f);
    part[((static_cast<long>(b) * slices + slice) * p.gs + gl) * nchunks + chunk] =
        make_float2(__fadd_rn(Kg, d), m2);
  }
}

// the row chunks' partials of one (frame, slice), merged in chunk order
__global__ void __launch_bounds__(kThreads) point_norm_merge_kernel(const float2* __restrict__ part,
                                                                     float* __restrict__ mean_out,
                                                                     float* __restrict__ rstd_out, int N, int G,
                                                                     Plan p, int rows, int nchunks, float eps) {
  __shared__ float red[kThreads], means[kThreads];
  const int b = blockIdx.x, slice = blockIdx.y, slices = gridDim.y;
  const int t = threadIdx.x, tpg = kThreads / p.gs, gl = t / tpg, q = t % tpg;
  const float2* pg = part + ((static_cast<long>(b) * slices + slice) * p.gs + gl) * nchunks;
  const float ntot = static_cast<float>(N * p.cg);
  // pass 1: the mean, sum n_c m_c over the chunks q, q + tpg, ... then over q
  float acc = 0.f;
  for (int c = q; c < nchunks; c += tpg) {
    const float nc = static_cast<float>((min(N, (c + 1) * rows) - c * rows) * p.cg);
    acc = __fmaf_rn(nc, pg[c].x, acc);
  }
  red[t] = acc;
  __syncthreads();
  if (q == 0) {
    float s = 0.f;
    for (int i = 0; i < tpg; ++i) s = __fadd_rn(s, red[t + i]);
    means[gl] = __fdiv_rn(s, ntot);
  }
  __syncthreads();
  const float mean = means[gl];
  // pass 2: M2 = sum M2_c + n_c (m_c - mean)^2
  acc = 0.f;
  for (int c = q; c < nchunks; c += tpg) {
    const float nc = static_cast<float>((min(N, (c + 1) * rows) - c * rows) * p.cg);
    const float2 pc = pg[c];
    const float d = __fsub_rn(pc.x, mean);
    acc = __fadd_rn(acc, __fmaf_rn(__fmul_rn(nc, d), d, pc.y));
  }
  red[t] = acc;
  __syncthreads();
  if (q == 0) {
    float s = 0.f;
    for (int i = 0; i < tpg; ++i) s = __fadd_rn(s, red[t + i]);
    const int g = slice * p.gs + gl;
    mean_out[b * G + g] = mean;
    rstd_out[b * G + g] = rsqrtf(__fadd_rn(__fdiv_rn(s, ntot), eps));
  }
}

template <typename T, bool RES, bool RELU>
__device__ __forceinline__ uint4 apply_vec(const uint4& u, const uint4& ru, const float* m, const float* rs,
                                           const float* w, const float* bi) {
  constexpr int VEC = Pack<T>::kVec;
  float f[VEC], rf[VEC];
  Pack<T>::unpack(u, f);
  if (RES) Pack<T>::unpack(ru, rf);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float y = __fmul_rn(__fmul_rn(__fsub_rn(f[e], m[e]), rs[e]), w[e]);
    y = Pack<T>::round(__fadd_rn(y, bi[e]));
    if (RES) y = Pack<T>::round(__fadd_rn(y, rf[e]));
    if (RELU) y = y >= 0.f ? y : Pack<T>::round(__fmul_rn(0.1f, y));
    f[e] = y;
  }
  return Pack<T>::pack(f);
}

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads) point_norm_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ mean, const float* __restrict__ rstd,
    T* __restrict__ out, int N, int C, int G, Plan p, int rows) {
  constexpr int VEC = Pack<T>::kVec;
  const int chunk = blockIdx.x, b = blockIdx.y, slice = blockIdx.z;
  const int t = threadIdx.x, col = t % p.cs, ry = t / p.cs;
  const int v = slice * p.cs + col;
  const int r0 = chunk * rows, r1 = min(N, r0 + rows);
  float m[VEC], rs[VEC], w[VEC], bi[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = v * VEC + e, g = b * G + c / p.cg;
    m[e] = mean[g];
    rs[e] = rstd[g];
    w[e] = weight[c];
    bi[e] = bias[c];
  }
  const long base = static_cast<long>(b) * N * C + v * VEC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int r = r0 + ry;
  for (; r + p.ry < r1; r += 2 * p.ry) {
    const long i0 = base + static_cast<long>(r) * C, i1 = i0 + static_cast<long>(p.ry) * C;
    const uint4 u0 = load_row(x + i0), u1 = load_row(x + i1);
    const uint4 ru0 = RES ? load_row(res + i0) : zero, ru1 = RES ? load_row(res + i1) : zero;
    *reinterpret_cast<uint4*>(out + i0) = apply_vec<T, RES, RELU>(u0, ru0, m, rs, w, bi);
    *reinterpret_cast<uint4*>(out + i1) = apply_vec<T, RES, RELU>(u1, ru1, m, rs, w, bi);
  }
  if (r < r1) {
    const long i0 = base + static_cast<long>(r) * C;
    const uint4 ru0 = RES ? load_row(res + i0) : zero;
    *reinterpret_cast<uint4*>(out + i0) = apply_vec<T, RES, RELU>(load_row(x + i0), ru0, m, rs, w, bi);
  }
}

template <typename T, int GPV>
void launch_stats(const void* x, void* part, void* mean, void* rstd, int B, int N, int C, int G, const Plan& p,
                  float eps, cudaStream_t stream) {
  const int rows = point_norm::chunk_rows(B, N, p, point_norm::kStatsBlocks, point_norm::kMaxChunks);
  const int nchunks = point_norm::chunk_count(N, rows);
  point_norm_stats_kernel<T, GPV><<<dim3(nchunks, B, p.slices), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(part), N, C, p, rows, nchunks);
  point_norm_merge_kernel<<<dim3(B, p.slices), kThreads, 0, stream>>>(
      static_cast<const float2*>(part), static_cast<float*>(mean), static_cast<float*>(rstd), N, G, p, rows,
      nchunks, eps);
}

template <typename T>
int stats_for(const void* x, void* part, void* mean, void* rstd, int B, int N, int C, int G, const Plan& p,
              float eps, cudaStream_t stream) {
  switch (p.gpv) {
    case 1: launch_stats<T, 1>(x, part, mean, rstd, B, N, C, G, p, eps, stream); break;
    case 2: launch_stats<T, 2>(x, part, mean, rstd, B, N, C, G, p, eps, stream); break;
    case 4: launch_stats<T, 4>(x, part, mean, rstd, B, N, C, G, p, eps, stream); break;
    case 8:  // bf16 alone: an fp32 vector holds 4 channels
      if constexpr (Pack<T>::kVec == 8) {
        launch_stats<T, 8>(x, part, mean, rstd, B, N, C, G, p, eps, stream);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RES, bool RELU>
void launch_apply(const void* x, const void* res, const void* weight, const void* bias, const void* mean,
                  const void* rstd, void* out, int B, int N, int C, int G, const Plan& p, cudaStream_t stream) {
  const int rows = point_norm::chunk_rows(B, N, p, point_norm::kApplyBlocks, 1 << 30);
  dim3 grid(point_norm::chunk_count(N, rows), B, p.slices);
  point_norm_apply_kernel<T, RES, RELU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(out), N, C, G, p, rows);
}

template <typename T>
int apply_for(const void* x, const void* res, const void* weight, const void* bias, const void* mean,
              const void* rstd, void* out, int B, int N, int C, int G, int relu, const Plan& p,
              cudaStream_t stream) {
  if (res != nullptr && relu) launch_apply<T, true, true>(x, res, weight, bias, mean, rstd, out, B, N, C, G, p, stream);
  else if (res != nullptr) launch_apply<T, true, false>(x, res, weight, bias, mean, rstd, out, B, N, C, G, p, stream);
  else if (relu) launch_apply<T, false, true>(x, res, weight, bias, mean, rstd, out, B, N, C, G, p, stream);
  else launch_apply<T, false, false>(x, res, weight, bias, mean, rstd, out, B, N, C, G, p, stream);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// x (B, N, C) contiguous, bf16 (x_bf16 = 1) or fp32, 16-byte aligned, C = G
// groups; part: B * G * kMaxChunks float2 of scratch; mean, rstd (B, G)
// fp32.  Two kernels: the chunks' partials, then their merge.
extern "C" int point_norm_stats_launch(const void* x, int x_bf16, void* part, void* mean, void* rstd, int B, int N,
                                       int C, int G, float eps, void* stream) {
  const Plan p = point_norm::make_plan(C, G, x_bf16 ? 2 : 4);
  if (!p.ok || B < 1 || N < 1 || B > 65535 || !aligned(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? stats_for<__nv_bfloat16>(x, part, mean, rstd, B, N, C, G, p, eps, s)
                : stats_for<float>(x, part, mean, rstd, B, N, C, G, p, eps, s);
}

// out = LeakyReLU?(round(((x - mean) * rstd) * weight + bias) [+ residual]),
// out and residual (may be null) as x; weight, bias (C) fp32; relu 0 or 1.
extern "C" int point_norm_apply_launch(const void* x, int x_bf16, const void* residual, const void* weight,
                                       const void* bias, const void* mean, const void* rstd, void* out, int B,
                                       int N, int C, int G, int relu, void* stream) {
  const Plan p = point_norm::make_plan(C, G, x_bf16 ? 2 : 4);
  if (!p.ok || B < 1 || N < 1 || B > 65535 || !aligned(x) || !aligned(out) ||
      (residual != nullptr && !aligned(residual)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? apply_for<__nv_bfloat16>(x, residual, weight, bias, mean, rstd, out, B, N, C, G, relu, p, s)
                : apply_for<float>(x, residual, weight, bias, mean, rstd, out, B, N, C, G, relu, p, s);
}
