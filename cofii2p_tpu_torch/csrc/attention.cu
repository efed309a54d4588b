// Fused softmax attention for Hopper (the I2P transformer's 16 calls).
//
// Replaces: cofii2p_tpu/ops/attention_kernel.py::fused_attention (body
// _attn_kernel).  Same function: out = softmax(q k^T / sqrt(D)) v per
// (frame, head), logits and softmax in fp32, output in q's dtype (bf16 in
// serving, fp32 on the `.t7` path).
//
// What bounds it on the H100: the L x S logits (1280 x 1280 per head), two
// products of D = 32 per logit and one exponential; operand bytes are
// small.  The TPU kernel held one (frame, head)'s whole K and V in VMEM,
// beyond the 227 KB of shared memory a block may use, so K and V stream
// through shared memory in 64-key chunks with an online (running max,
// running sum) fp32 softmax; the (L, S) matrix never exists in memory.
//
// Both bodies run on the tensor cores (mma.sync, fp32 accumulate; wgmma's
// 64-row tiles buy nothing at D = 32) in one shape: a block takes 64
// queries of one (frame, head), 16 per warp, their Q fragments loaded once
// into registers; K and V chunks arrive by 16-byte cp.async, double
// buffered.  S = Q K^T is fp32 and divided by sqrt(D) as the TPU kernel
// does, the quotient correctly rounded in three operations (exact_div); the
// ragged tail of S is masked to -inf (in the last chunk only) and that of L
// guarded at the store.  The row max and sum are reduced over each quad of
// lanes with shuffles; the output is acc / denom in fp32.
//
// bf16 inputs (m16n8k16): Q and K in bf16, V's B fragments through
// ldmatrix.trans.  P stays near fp32, as in the TPU kernel's fp32 P @ V: it
// is split into P_hi + P_lo, two bf16 terms, and both go through the tensor
// cores into the same fp32 accumulator, so rounding P once to bf16 adds no
// error of its own.
//
// fp32 inputs (m16n8k8 .tf32, by 3xTF32): every operand, Q (once), K, P and
// V (at their fragment loads), is split into tf32 hi + lo (cvt.rna), and
// lo*hi + hi*lo + hi*hi of each 8-deep k-step, summed from zero on the
// tensor cores, is added to the fp32 S or output accumulator with
// round-to-nearest (cofii2p::mma_tf32x3): about 2^-21 relative, where one
// TF32 product's 2^-11 would miss the 1e-5 gate.  P needs no shuffle: the
// S fragment gives a lane keys 2t and 2t + 1 of an 8-key tile, so P V's
// k-step takes key 2t for k-index t and 2t + 1 for t + 4, and V's B
// fragment reads the same two key rows.  Shared rows of 36 floats put the
// 32 lanes' fragment loads of K and of V on 32 distinct banks.

#include "mma.cuh"

namespace {

// a / b correctly rounded, given rb = 1 / b correctly rounded, for normal
// quotients (Markstein: the residual a - q b is exact in one FMA, and one
// more FMA rounds q + rb (a - q b) to the nearest float), the value the
// plain version's division takes
__device__ __forceinline__ float exact_div(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

constexpr int kD = 32;      // head width
constexpr int kChunk = 64;  // keys per shared-memory chunk
constexpr int kMmaQ = 64;   // queries per block: 4 warps of 16
constexpr int kStride = kD + 8;  // shared row of one bf16 key, padded against bank conflicts
constexpr int kF32Stride = kD + 4;  // shared row of one fp32 key

// out[r, d], out[r, d + 1] = a, bb in fp32 or bf16
__device__ __forceinline__ void store_pair(void* out, long idx, int out_bf16, float a, float bb) {
  if (out_bf16)
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) = cofii2p::pack_bf16(a, bb);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(a, bb);
}

// The fp32 body (see the header): grid (ceil(L / 64), B * H), 128 threads.
__global__ void __launch_bounds__(128) attention_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, void* __restrict__ out,
    int out_bf16, int L, int S, int H) {
  __shared__ __align__(16) float k_s[2][kChunk][kF32Stride];
  __shared__ __align__(16) float v_s[2][kChunk][kF32Stride];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int r0 = blockIdx.x * kMmaQ + warp * 16 + g, r1 = r0 + 8;  // this lane's two query rows
  const long stride = (long)H * kD;  // elements from one position to the next
  const float* qb = q + (long)b * L * stride + h * kD;
  const float* kb = k + (long)b * S * stride + h * kD;
  const float* vb = v + (long)b * S * stride + h * kD;
  const float scale = sqrtf(static_cast<float>(kD));
  const float inv_scale = 1.f / scale;

  // A fragments of the warp's 16 queries, 4 k-steps over D, split once:
  // a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
  uint32_t qh[4][4], ql[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 8 + t;
    cofii2p::split_tf32(r0 < L ? qb[r0 * stride + c] : 0.f, qh[ks][0], ql[ks][0]);
    cofii2p::split_tf32(r1 < L ? qb[r1 * stride + c] : 0.f, qh[ks][1], ql[ks][1]);
    cofii2p::split_tf32(r0 < L ? qb[r0 * stride + c + 4] : 0.f, qh[ks][2], ql[ks][2]);
    cofii2p::split_tf32(r1 < L ? qb[r1 * stride + c + 4] : 0.f, qh[ks][3], ql[ks][3]);
  }

  float o[4][4];  // output fragments, 4 n-tiles over D
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, den0 = 0.f, den1 = 0.f;  // rows r0, r1; den over this lane's keys

  auto load = [&](int chunk, int stage) {
    for (int i = tid; i < kChunk * 8; i += 128) {  // 64 keys x 8 pieces of 16 bytes
      const int r = i >> 3, p = i & 7;
      const int s = chunk * kChunk + r;
      const long off = (long)(s < S ? s : 0) * stride + p * 4;
      cofii2p::cp_async16(&k_s[stage][r][p * 4], kb + off, s < S ? 16 : 0);
      cofii2p::cp_async16(&v_s[stage][r][p * 4], vb + off, s < S ? 16 : 0);
    }
    cofii2p::cp_async_commit();
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < n_chunks) {
      load(c + 1, st ^ 1);
      cofii2p::cp_async_wait<1>();
    } else {
      cofii2p::cp_async_wait<0>();
    }
    __syncthreads();

    // logits of 64 keys: 8 n-tiles; K's B fragment b0 = (k t, key g),
    // b1 = (k t + 4, key g)
    float x[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
      const float* kr = &k_s[st][nt * 8 + g][t];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bh0, bl0, bh1, bl1;
        cofii2p::split_tf32(kr[ks * 8], bh0, bl0);
        cofii2p::split_tf32(kr[ks * 8 + 4], bh1, bl1);
        cofii2p::mma_tf32x3(x[nt], qh[ks], ql[ks], bh0, bh1, bl0, bl1);
      }
    }
    float cmax0 = -INFINITY, cmax1 = -INFINITY;
    const bool full = (c + 1) * kChunk <= S;  // uniform: only the last chunk has a tail
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = exact_div(x[nt][e], scale, inv_scale);
      if (!full) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c * kChunk + nt * 8 + 2 * t + e >= S) x[nt][e] = x[nt][2 + e] = -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cmax0 = fmaxf(cmax0, x[nt][e]);
        cmax1 = fmaxf(cmax1, x[nt][2 + e]);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      cmax0 = fmaxf(cmax0, __shfl_xor_sync(0xffffffffu, cmax0, sh));
      cmax1 = fmaxf(cmax1, __shfl_xor_sync(0xffffffffu, cmax1, sh));
    }
    const float mn0 = fmaxf(m0, cmax0), mn1 = fmaxf(m1, cmax1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);  // 0 on the first chunk
    den0 *= corr0;
    den1 *= corr1;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      o[nt][0] *= corr0, o[nt][1] *= corr0;
      o[nt][2] *= corr1, o[nt][3] *= corr1;
    }
    m0 = mn0, m1 = mn1;

    // o += P V, 8 k-steps of 8 keys: k-index t is key 2t of the tile,
    // t + 4 key 2t + 1, in P's A fragment and in V's B fragment alike
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = expf(x[j][0] - mn0), p01 = expf(x[j][1] - mn0);  // row r0, keys 2t, 2t + 1
      const float p10 = expf(x[j][2] - mn1), p11 = expf(x[j][3] - mn1);  // row r1
      den0 += p00 + p01;
      den1 += p10 + p11;
      uint32_t ah[4], al[4];  // a0 = (r0, key 2t), a1 = (r1, 2t), a2 = (r0, 2t + 1), a3 = (r1, 2t + 1)
      cofii2p::split_tf32(p00, ah[0], al[0]);
      cofii2p::split_tf32(p10, ah[1], al[1]);
      cofii2p::split_tf32(p01, ah[2], al[2]);
      cofii2p::split_tf32(p11, ah[3], al[3]);
      const float* vr = &v_s[st][j * 8 + 2 * t][g];
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t bh0, bl0, bh1, bl1;
        cofii2p::split_tf32(vr[dn * 8], bh0, bl0);               // (key 2t, d)
        cofii2p::split_tf32(vr[kF32Stride + dn * 8], bh1, bl1);  // (key 2t + 1, d)
        cofii2p::mma_tf32x3(o[dn], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();  // the next load reuses this stage
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    den0 += __shfl_xor_sync(0xffffffffu, den0, sh);
    den1 += __shfl_xor_sync(0xffffffffu, den1, sh);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int d = nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= L) continue;
      const float den = half ? den1 : den0;
      store_pair(out, ((long)b * L + r) * stride + h * kD + d, out_bf16, o[nt][2 * half] / den,
                 o[nt][2 * half + 1] / den);
    }
  }
}

// The bf16 body (see the header): grid (ceil(L / 64), B * H), 128 threads.
__global__ void __launch_bounds__(128) attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, void* __restrict__ out, int out_bf16,
    int L, int S, int H) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kChunk][kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kChunk][kStride];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int r0 = blockIdx.x * kMmaQ + warp * 16 + g, r1 = r0 + 8;  // this lane's two query rows
  const long stride = (long)H * kD;  // elements from one position to the next
  const __nv_bfloat16* qb = q + (long)b * L * stride + h * kD;
  const __nv_bfloat16* kb = k + (long)b * S * stride + h * kD;
  const __nv_bfloat16* vb = v + (long)b * S * stride + h * kD;
  const float scale = sqrtf(static_cast<float>(kD));
  const float inv_scale = 1.f / scale;

  uint32_t qf[2][4];  // A fragments of the warp's 16 queries, 2 k-steps over D
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(qb + r0 * stride + c) : 0u;
    qf[ks][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(qb + r1 * stride + c) : 0u;
    qf[ks][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(qb + r0 * stride + c + 8) : 0u;
    qf[ks][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(qb + r1 * stride + c + 8) : 0u;
  }

  float o[4][4];  // output fragments, 4 n-tiles over D
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, den0 = 0.f, den1 = 0.f;  // rows r0, r1; den over this lane's keys

  auto load = [&](int chunk, int stage) {
    for (int i = tid; i < kChunk * 4; i += 128) {  // 64 keys x 4 pieces of 16 bytes
      const int r = i >> 2, p = i & 3;
      const int s = chunk * kChunk + r;
      const long off = (long)(s < S ? s : 0) * stride + p * 8;
      cofii2p::cp_async16(&k_s[stage][r][p * 8], kb + off, s < S ? 16 : 0);
      cofii2p::cp_async16(&v_s[stage][r][p * 8], vb + off, s < S ? 16 : 0);
    }
    cofii2p::cp_async_commit();
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < n_chunks) {
      load(c + 1, st ^ 1);
      cofii2p::cp_async_wait<1>();
    } else {
      cofii2p::cp_async_wait<0>();
    }
    __syncthreads();

    // logits of 64 keys: 8 n-tiles
    float x[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t kf[4];
      cofii2p::ldsm_x4(kf, &k_s[st][nt * 8 + (lane & 7)][(lane >> 3) * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
      cofii2p::mma_bf16(x[nt], qf[0], kf[0], kf[1]);
      cofii2p::mma_bf16(x[nt], qf[1], kf[2], kf[3]);
    }
    float cmax0 = -INFINITY, cmax1 = -INFINITY;
    const bool full = (c + 1) * kChunk <= S;  // uniform: only the last chunk has a tail
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = exact_div(x[nt][e], scale, inv_scale);
      if (!full) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c * kChunk + nt * 8 + 2 * t + e >= S) x[nt][e] = x[nt][2 + e] = -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cmax0 = fmaxf(cmax0, x[nt][e]);
        cmax1 = fmaxf(cmax1, x[nt][2 + e]);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      cmax0 = fmaxf(cmax0, __shfl_xor_sync(0xffffffffu, cmax0, sh));
      cmax1 = fmaxf(cmax1, __shfl_xor_sync(0xffffffffu, cmax1, sh));
    }
    const float mn0 = fmaxf(m0, cmax0), mn1 = fmaxf(m1, cmax1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);  // 0 on the first chunk
    den0 *= corr0;
    den1 *= corr1;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      o[nt][0] *= corr0, o[nt][1] *= corr0;
      o[nt][2] *= corr1, o[nt][3] *= corr1;
    }
    m0 = mn0, m1 = mn1;

    // o += P V, 4 k-steps of 16 keys; P = P_hi + P_lo
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[8];  // a0..a3's values: tiles 2j and 2j+1, rows r0 / r1
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float* xs = x[2 * j + h2];
        p[4 * h2 + 0] = expf(xs[0] - mn0);
        p[4 * h2 + 1] = expf(xs[1] - mn0);
        p[4 * h2 + 2] = expf(xs[2] - mn1);
        p[4 * h2 + 3] = expf(xs[3] - mn1);
        den0 += p[4 * h2 + 0] + p[4 * h2 + 1];
        den1 += p[4 * h2 + 2] + p[4 * h2 + 3];
      }
      uint32_t ahi[4], alo[4];  // P_hi = bf16(P), P_lo = bf16(P - P_hi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ahi[e] = cofii2p::pack_bf16(p[2 * e], p[2 * e + 1]);
        alo[e] = cofii2p::pack_bf16(p[2 * e] - __uint_as_float(ahi[e] << 16),
                                    p[2 * e + 1] - __uint_as_float(ahi[e] & 0xffff0000u));
      }
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t vf[4];
        cofii2p::ldsm_x4_trans(vf, &v_s[st][j * 16 + (lane & 15)][dp * 16 + (lane >> 4) * 8]);
        cofii2p::mma_bf16(o[2 * dp], ahi, vf[0], vf[1]);
        cofii2p::mma_bf16(o[2 * dp], alo, vf[0], vf[1]);
        cofii2p::mma_bf16(o[2 * dp + 1], ahi, vf[2], vf[3]);
        cofii2p::mma_bf16(o[2 * dp + 1], alo, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next load reuses this stage
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    den0 += __shfl_xor_sync(0xffffffffu, den0, sh);
    den1 += __shfl_xor_sync(0xffffffffu, den1, sh);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int d = nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= L) continue;
      const float den = half ? den1 : den0;
      store_pair(out, ((long)b * L + r) * stride + h * kD + d, out_bf16, o[nt][2 * half] / den,
                 o[nt][2 * half + 1] / den);
    }
  }
}

}  // namespace

// q (B, L, H, D), k and v (B, S, H, D), all fp32 or all bf16, each 16-byte
// aligned; out (B, L, H, D) fp32 or bf16.  D must be 32.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* out, int in_bf16, int out_bf16, int B,
                                int L, int S, int H, int D, void* stream) {
  if (D != kD || S < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kMmaQ - 1) / kMmaQ, B * H);
  if (in_bf16)
    attention_mma_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), out, out_bf16, L, S, H);
  else
    attention_tf32x3_kernel<<<grid, 128, 0, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                  static_cast<const float*>(v), out, out_bf16, L, S, H);
  return static_cast<int>(cudaGetLastError());
}
