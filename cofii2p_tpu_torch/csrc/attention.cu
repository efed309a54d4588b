// Fused softmax attention for Hopper (the I2P transformer's 16 calls).
//
// Replaces: cofii2p_tpu/ops/attention_kernel.py::fused_attention (body
// _attn_kernel).  Same function: out = softmax(q k^T / sqrt(D)) v per
// (frame, head), logits and softmax in fp32, output in q's dtype (bf16 in
// serving).
//
// What bounds it on the H100: the L x S logits (1280 x 1280 per head), two
// products of D = 32 per logit and one exponential; operand bytes are
// small.  The TPU kernel held one (frame, head)'s whole K and V in VMEM,
// beyond the 227 KB of shared memory a block may use, so K and V stream
// through shared memory in 64-key chunks with an online (running max,
// running sum) fp32 softmax; the (L, S) matrix never exists in memory.
//
// bf16 inputs run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate; wgmma's 64-row tiles buy nothing at D = 32): a block takes 64
// queries of one (frame, head), 16 per warp, their Q fragments loaded once
// into registers; K and V chunks arrive by 16-byte cp.async, double
// buffered, V's B fragments through ldmatrix.trans.  S = Q K^T is fp32 and
// divided by sqrt(D) as the TPU kernel does, the quotient correctly rounded
// in three operations (exact_div); the ragged tail of S is masked to -inf
// (in the last chunk only) and that of L guarded at the store.  The row max and sum are
// reduced over each quad of lanes with shuffles.  P stays near fp32, as in
// the TPU kernel's fp32 P @ V: it is split into P_hi + P_lo, two bf16
// terms, and both go through the tensor cores into the same fp32
// accumulator, so rounding P once to bf16 adds no error of its own.
//
// fp32 inputs (the `.t7` path) keep the CUDA-core body: one query per
// thread, its query and D = 32 accumulators in registers, K and V chunks in
// shared memory as fp32.

#include "mma.cuh"

namespace {

// a / b correctly rounded, given rb = 1 / b correctly rounded, for normal
// quotients (Markstein: the residual a - q b is exact in one FMA, and one
// more FMA rounds q + rb (a - q b) to the nearest float); the CUDA-core
// body's a / b takes the same value through div.rn's longer sequence
__device__ __forceinline__ float exact_div(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

constexpr int kD = 32;      // head width
constexpr int kThreads = 64;  // queries per block (fp32 body)
constexpr int kChunk = 64;  // keys per shared-memory chunk
constexpr int kMmaQ = 64;   // queries per block (bf16 body): 4 warps of 16
constexpr int kStride = kD + 8;  // shared row of one key, padded against bank conflicts

__global__ void __launch_bounds__(kThreads) attention_kernel(
    const void* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, void* __restrict__ out, int in_bf16,
    int out_bf16, int L, int S, int H) {
  __shared__ float k_s[kChunk][kD];
  __shared__ float v_s[kChunk][kD];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int l = blockIdx.x * kThreads + tid;
  const bool live = l < L;
  const float scale = sqrtf(static_cast<float>(kD));

  float qv[kD], acc[kD];
  const long qbase = (((long)b * L + (live ? l : 0)) * H + h) * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qv[d] = cofii2p::load_f(q, qbase + d, in_bf16);
    acc[d] = 0.f;
  }
  float m = -INFINITY, denom = 0.f;

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int ns = min(kChunk, S - s0);
    for (int i = tid; i < kChunk * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      float kv = 0.f, vv = 0.f;
      if (r < ns) {
        const long o = (((long)b * S + s0 + r) * H + h) * kD + d;
        kv = cofii2p::load_f(k, o, in_bf16);
        vv = cofii2p::load_f(v, o, in_bf16);
      }
      k_s[r][d] = kv;
      v_s[r][d] = vv;
    }
    __syncthreads();

    float x[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot += qv[d] * k_s[j][d];
      x[j] = j < ns ? dot / scale : -INFINITY;
      cmax = fmaxf(cmax, x[j]);
    }
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);  // 0 on the first chunk
    denom *= corr;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float p = expf(x[j] - m_new);
      denom += p;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] += p * v_s[j][d];
    }
    m = m_new;
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const float o = acc[d] / denom;
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[qbase + d] = __float2bfloat16(o);
    else
      static_cast<float*>(out)[qbase + d] = o;
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
      const float a = o[nt][2 * half] / den, bb = o[nt][2 * half + 1] / den;
      const long idx = ((long)b * L + r) * stride + h * kD + d;
      if (out_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) = cofii2p::pack_bf16(a, bb);
      } else {
        static_cast<float*>(out)[idx] = a;
        static_cast<float*>(out)[idx + 1] = bb;
      }
    }
  }
}

}  // namespace

// q (B, L, H, D), k and v (B, S, H, D), all fp32 or all bf16; out
// (B, L, H, D) fp32 or bf16.  D must be 32.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* out, int in_bf16, int out_bf16, int B,
                                int L, int S, int H, int D, void* stream) {
  if (D != kD || S < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    dim3 grid((L + kMmaQ - 1) / kMmaQ, B * H);
    attention_mma_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), out, out_bf16, L, S, H);
  } else {
    dim3 grid((L + kThreads - 1) / kThreads, B * H);
    attention_kernel<<<grid, kThreads, 0, st>>>(q, k, v, out, in_bf16, out_bf16, L, S, H);
  }
  return static_cast<int>(cudaGetLastError());
}
