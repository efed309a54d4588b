// Banded KPConv for Hopper on the CUDA cores: neighbor aggregation with the
// kernel-weight contraction fused in.  Kernel #1 in fp32 and #16's fp32
// POOL mode run it; #1 in bf16 and #16 in bf16 run kpconv_mma.cuh, and the
// aggregate (#2) and the k-NN variants (#6, #7) kpconv_tau_mma.cuh, all on
// the tensor cores.
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::banded_kpconv_fused_pallas
// (body _agg_fused_kernel).  For each query m,
//   out[m, :] = sum_k ( sum_j infl_k(q_m, s_j) f_j ) @ W_k
// over the band rows j of m's 128-query tile that lie within kernel reach,
// plus count[m] = max(#in-reach band rows, 1).  The output is fp32 and
// unnormalised; the caller divides by count and adds the bias.
//
// What bounds it on the H100: at the deep levels (Cin = Cout = 512) the
// contraction (15 * Cin * Cout MACs per query) and the weight reads; at the
// shallow levels the influence math over the band.  The TPU kernel kept a
// (tile, 15 * Cin) fp32 accumulator in VMEM, 3.9 MB at Cin = 512, which is
// far beyond the 227 KB of shared memory a block may use.  So here the
// kernel point k is the outer loop: a block of TQ queries accumulates one
// (TQ, Cin) partial sum over the band in registers, parks it in shared
// memory, and adds acc_k @ W_k into a (TQ, Cout) output held in registers
// (W_k read from global memory, where L2 keeps it hot across blocks).
// Band rows with no in-reach query of the block are compacted out once per
// block (an ordered list in shared memory), so the 15 passes only touch
// rows that contribute.
//
// Exactness: membership d2 is computed as the JAX package computes it,
// centred on the first query of the 128-row band tile (also when the block
// covers fewer queries), with round-to-nearest intrinsics so no FMA is
// contracted; the in-reach counts therefore equal the plain version's.
// Influence takes its offset from the uncentred coordinates, s_j - q_m,
// which is exact for nearby points: centred on a tile reference metres
// away (a tile can straddle a Morton jump) each coordinate rounds at the
// reference's scale, ~4e-6 m at 32 m, an influence error of ~2e-5.
// bf16 rounding points follow the TPU kernel: influence and features are
// rounded to the compute dtype before their product, the fp32 accumulator
// is rounded before the contraction, W arrives already rounded.
//
// POOL (kernel #16, csrc/residual_fused.cu): the strided ResidualBlock's
// shortcut maxpool rides on the membership pass.  While the first kernel
// point's pass builds a segment's active-row list, each warp also parks its
// per-query ballot (1 bit per query and band row, the bits the count adds
// up) in the ``work`` buffer, which is idle until the influence chunks;
// the block then walks each query's set bits over the block-input features
// (Cmp channels; a thread takes 4 adjacent channels of one query in one
// 8- or 16-byte load per member row, coalesced over channels) for the max,
// before the aggregation takes ``work`` back.  Band rows are
// thus tested once for both halves; the conv half is this kernel unchanged,
// so its sums and counts are #1's bit for bit at the same TQ.  Over more
// than one segment the running max is kept in the output, read back by the
// thread that wrote it.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kE = 32;       // accumulator elements per thread
constexpr int kSeg = 2048;   // band rows per active-list segment
constexpr int kRB = 32;      // active rows per influence chunk
constexpr int kMaxTQ = 128;  // queries per block at most (one band tile)
constexpr int kAccElems = kThreads * kE;  // TQ * pad(Cin) bound
constexpr int kWords = kSeg / 32;  // POOL: mask words per query and segment
static_assert(kMaxTQ * kWords <= kAccElems, "the POOL masks live in work");

// V channels of f from element idx (V = 4: one 8- or 16-byte load, idx a
// multiple of 4 and the pointer 16-byte aligned), as fp32.
template <int V>
__device__ __forceinline__ void load_v(const void* p, long idx, int is_bf16, float* v) {
  if constexpr (V == 4) {
    if (is_bf16) {
      const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + idx);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + idx);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    }
  } else {
    v[0] = cofii2p::load_f(p, idx, is_bf16);
  }
}

template <int V>
__device__ __forceinline__ void store_v(void* p, long idx, int is_bf16, const float* v) {
  if constexpr (V == 4) {
    if (is_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 raw;
      raw.x = *reinterpret_cast<const unsigned*>(&lo);
      raw.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + idx) = raw;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p) + idx) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else if (is_bf16) {
    static_cast<__nv_bfloat16*>(p)[idx] = __float2bfloat16(v[0]);
  } else {
    static_cast<float*>(p)[idx] = v[0];
  }
}

// POOL's max over one membership segment: (query, V channels) items spread
// over the block, each walking its query's set bits in row order; the
// running max starts at -inf (first segment) or is read back from out,
// and the last segment writes 0 where the query has no member.  A max is
// exact, so the result equals #3's whatever the item shape.
template <int V>
__device__ __forceinline__ void pool_segment(const unsigned* mask, const void* f, int f_bf16, void* out, int C, int TQ,
                                             int nwords, bool first, bool last, const int* cnt, long frow0, long out0,
                                             int tid) {
  const int G = C / V;
  for (int idx = tid; idx < TQ * G; idx += kThreads) {
    const int q = idx / G, c = (idx - q * G) * V;
    const long o = out0 + (long)q * C + c;
    float mx[V];
    if (first) {
#pragma unroll
      for (int v = 0; v < V; ++v) mx[v] = -INFINITY;
    } else {
      load_v<V>(out, o, f_bf16, mx);
    }
    for (int w = 0; w < nwords; ++w) {
      unsigned bits = mask[q * kWords + w];
      while (bits) {
        const int j = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        float fv[V];
        load_v<V>(f, frow0 + (long)j * C + c, f_bf16, fv);
#pragma unroll
        for (int v = 0; v < V; ++v) mx[v] = fmaxf(mx[v], fv[v]);
      }
    }
    if (last && cnt[q] == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) mx[v] = 0.f;
    }
    store_v<V>(out, o, f_bf16, mx);
  }
}

// A = 0: Cin padded to a power of two below 256, so a thread owns one
// channel and the queries q0 + R * i.  A >= 1: Cin padded to 256 * A, so a
// thread owns channels tid + 256 * a (a < A) of queries i / A.  AO is the
// same for the output width.  out (B, M, Cout) = sum_k acc_k @ W_k.
// POOL: also mp_out (B, M, Cmp) in mp_feats'
// dtype = the max of mp_feats (B, N, Cmp) over the in-reach band rows, 0
// where there is none.
template <int A, int AO, bool POOL = false>
__global__ void __launch_bounds__(kThreads) kpconv_fused_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const void* __restrict__ feats, int f_bf16, const float* __restrict__ W,
    const float* __restrict__ kp, const int* __restrict__ starts,
    float* __restrict__ out, int* __restrict__ count, int M, int N, int Cin,
    int Cout, int K, int tile, int num_tiles, int band, int TQ, int cin_shift,
    int cout_shift, float r2, float sigma, int round,
    const void* __restrict__ mp_feats, int mp_bf16, int Cmp,
    void* __restrict__ mp_out) {
  __shared__ float qc_s[kMaxTQ * 3];
  __shared__ float qa_s[kMaxTQ * 3];  // uncentred, for the influence
  __shared__ float pc_s[kRB * 3];
  __shared__ float pa_s[kRB * 3];
  __shared__ int cnt_s[kMaxTQ];
  __shared__ int act[kSeg];
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int n_act_s;
  __shared__ float work[kAccElems];  // influence chunk, then acc_k
  unsigned* mask = reinterpret_cast<unsigned*>(work);  // POOL, k = 0 only

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * TQ;
  const int t = m0 / tile;
  const int start = starts[b * num_tiles + t];
  const float* ref_p = q_pts + ((long)b * M + (long)t * tile) * 3;
  const float ref0 = ref_p[0], ref1 = ref_p[1], ref2 = ref_p[2];
  const float* srow = s_pts + ((long)b * N + start) * 3;
  const long frow0 = ((long)b * N + start) * Cin;

  for (int i = tid; i < TQ * 3; i += kThreads) {
    qa_s[i] = q_pts[((long)b * M + m0) * 3 + i];
    qc_s[i] = __fsub_rn(qa_s[i], ref_p[i % 3]);
  }
  for (int i = tid; i < TQ; i += kThreads) cnt_s[i] = 0;
  __syncthreads();

  // thread -> (query, channel) maps of the accumulator and the output
  const int cin_mask = (1 << cin_shift) - 1;
  const int cout_mask = (1 << cout_shift) - 1;
  const int R = A == 0 ? (kThreads >> cin_shift) : 0;
  const int q0 = A == 0 ? (tid >> cin_shift) : 0;
  const int RO = AO == 0 ? (kThreads >> cout_shift) : 0;
  const int qo0 = AO == 0 ? (tid >> cout_shift) : 0;

  float o[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) o[i] = 0.f;

  const bool one_seg = band <= kSeg;
  for (int k = 0; k < K; ++k) {
    const float kx = kp[k * 3], ky = kp[k * 3 + 1], kz = kp[k * 3 + 2];
    float acc[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) acc[i] = 0.f;

    for (int seg0 = 0; seg0 < band; seg0 += kSeg) {
      const int seg1 = min(band, seg0 + kSeg);
      if (k == 0 || !one_seg) {
        // ordered list of segment rows with at least one in-reach query;
        // the first pass also counts in-reach rows per query
        int base = 0;
        for (int r0 = seg0; r0 < seg1; r0 += kThreads) {
          const int j = r0 + tid;
          const bool valid = j < seg1;
          float px = 0.f, py = 0.f, pz = 0.f;
          if (valid) {
            px = __fsub_rn(srow[j * 3], ref0);
            py = __fsub_rn(srow[j * 3 + 1], ref1);
            pz = __fsub_rn(srow[j * 3 + 2], ref2);
          }
          bool any = false;
          for (int q = 0; q < TQ; ++q) {
            const float d2 = cofii2p::membership_d2(qc_s + 3 * q, px, py, pz);
            const bool in = valid && d2 <= r2;
            any |= in;
            if (k == 0) {
              const unsigned bits = __ballot_sync(0xffffffffu, in);
              if (lane == 0 && bits) atomicAdd(&cnt_s[q], __popc(bits));
              if (POOL && lane == 0) mask[q * kWords + (r0 - seg0) / 32 + warp] = bits;
            }
          }
          const unsigned flags = __ballot_sync(0xffffffffu, any);
          if (lane == 0) warp_tot[warp] = __popc(flags);
          __syncthreads();
          int off = base, total = 0;
          for (int w = 0; w < kThreads / 32; ++w) {
            if (w < warp) off += warp_tot[w];
            total += warp_tot[w];
          }
          if (any) act[off + __popc(flags & ((1u << lane) - 1u))] = j - seg0;
          base += total;
          __syncthreads();
        }
        if (tid == 0) n_act_s = base;
        __syncthreads();
        if constexpr (POOL) {
          if (k == 0) {
            // the shortcut over this segment's members; cnt_s is complete
            // once the last segment's ballots are in
            const int nwords = (seg1 - seg0 + 31) / 32;
            const long mrow0 = ((long)b * N + start + seg0) * Cmp;
            const long out0 = ((long)b * M + m0) * Cmp;
            const bool vec = (Cmp & 3) == 0 &&
                             ((reinterpret_cast<unsigned long long>(mp_feats) |
                               reinterpret_cast<unsigned long long>(mp_out)) & 15) == 0;
            if (vec)
              pool_segment<4>(mask, mp_feats, mp_bf16, mp_out, Cmp, TQ, nwords, seg0 == 0, seg1 == band, cnt_s,
                              mrow0, out0, tid);
            else
              pool_segment<1>(mask, mp_feats, mp_bf16, mp_out, Cmp, TQ, nwords, seg0 == 0, seg1 == band, cnt_s,
                              mrow0, out0, tid);
            __syncthreads();  // the aggregation takes work back
          }
        }
      }
      const int n_act = n_act_s;

      for (int r0 = 0; r0 < n_act; r0 += kRB) {
        const int nr = min(kRB, n_act - r0);
        if (tid < nr * 3) {
          const int j = seg0 + act[r0 + tid / 3];
          pa_s[tid] = srow[j * 3 + tid % 3];
          pc_s[tid] = __fsub_rn(pa_s[tid], ref_p[tid % 3]);
        }
        __syncthreads();
        // influence of kernel point k for (query, chunk row)
        for (int idx = tid; idx < TQ * kRB; idx += kThreads) {
          const int q = idx / kRB, r = idx % kRB;
          float v = 0.f;
          if (r < nr) {
            const float* qc = qc_s + 3 * q;
            const float* pc = pc_s + 3 * r;
            const float d2 = cofii2p::membership_d2(qc, pc[0], pc[1], pc[2]);
            if (d2 <= r2) {
              const float* qa = qa_s + 3 * q;
              const float* pa = pa_s + 3 * r;
              const float dx = (pa[0] - qa[0]) - kx;
              const float dy = (pa[1] - qa[1]) - ky;
              const float dz = (pa[2] - qa[2]) - kz;
              v = fmaxf(1.f - sqrtf(dx * dx + dy * dy + dz * dz) / sigma, 0.f);
              if (round) v = cofii2p::round_bf16(v);
            }
          }
          work[q * kRB + r] = v;
        }
        __syncthreads();
        for (int r = 0; r < nr; ++r) {
          const long frow = frow0 + (long)(seg0 + act[r0 + r]) * Cin;
          if (A == 0) {
            const int c = tid & cin_mask;
            float fv = c < Cin ? cofii2p::load_f(feats, frow + c, f_bf16) : 0.f;
            if (round) fv = cofii2p::round_bf16(fv);
#pragma unroll
            for (int i = 0; i < kE; ++i) {
              const int q = q0 + R * i;
              if (q < TQ) acc[i] += work[q * kRB + r] * fv;
            }
          } else {
            float fv[A > 0 ? A : 1];
#pragma unroll
            for (int a = 0; a < A; ++a) {
              const int c = tid + kThreads * a;
              fv[a] = c < Cin ? cofii2p::load_f(feats, frow + c, f_bf16) : 0.f;
              if (round) fv[a] = cofii2p::round_bf16(fv[a]);
            }
#pragma unroll
            for (int i = 0; i < kE; ++i) {
              const int q = i / (A > 0 ? A : 1);
              if (q < TQ) acc[i] += work[q * kRB + r] * fv[i % (A > 0 ? A : 1)];
            }
          }
        }
        __syncthreads();
      }
    }

    // park acc_k (rounded to the compute dtype) as a (TQ, Cin) matrix
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      int q, c;
      if (A == 0) {
        q = q0 + R * i;
        c = tid & cin_mask;
      } else {
        q = i / (A > 0 ? A : 1);
        c = tid + kThreads * (i % (A > 0 ? A : 1));
      }
      if (q < TQ && c < Cin) work[q * Cin + c] = round ? cofii2p::round_bf16(acc[i]) : acc[i];
    }
    __syncthreads();

    // o += acc_k @ W_k
    const float* Wk = W + (long)k * Cin * Cout;
    for (int c = 0; c < Cin; ++c) {
      const float* wrow = Wk + (long)c * Cout;
      if (AO == 0) {
        const int d = tid & cout_mask;
        const float w = d < Cout ? wrow[d] : 0.f;
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          const int q = qo0 + RO * i;
          if (q < TQ) o[i] += work[q * Cin + c] * w;
        }
      } else {
        float w[AO > 0 ? AO : 1];
#pragma unroll
        for (int a = 0; a < AO; ++a) {
          const int d = tid + kThreads * a;
          w[a] = d < Cout ? wrow[d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          const int q = i / (AO > 0 ? AO : 1);
          if (q < TQ) o[i] += work[q * Cin + c] * w[i % (AO > 0 ? AO : 1)];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kE; ++i) {
    int q, d;
    if (AO == 0) {
      q = qo0 + RO * i;
      d = tid & cout_mask;
    } else {
      q = i / (AO > 0 ? AO : 1);
      d = tid + kThreads * (i % (AO > 0 ? AO : 1));
    }
    if (q < TQ && d < Cout) out[((long)b * M + m0 + q) * Cout + d] = o[i];
  }
  for (int q = tid; q < TQ; q += kThreads) count[(long)b * M + m0 + q] = max(cnt_s[q], 1);
}

inline int log2_pad(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

template <int A, int AO, bool POOL = false>
void launch(dim3 grid, cudaStream_t st, const float* q, const float* s,
            const void* f, int f_bf16, const float* W, const float* kp,
            const int* starts, float* out, int* count, int M, int N, int Cin,
            int Cout, int K, int tile, int num_tiles, int band, int TQ,
            int cs, int os, float r2, float sigma, int round,
            const void* mp_feats = nullptr, int mp_bf16 = 0, int Cmp = 0,
            void* mp_out = nullptr) {
  kpconv_fused_kernel<A, AO, POOL><<<grid, kThreads, 0, st>>>(
      q, s, f, f_bf16, W, kp, starts, out, count, M, N, Cin, Cout, K, tile,
      num_tiles, band, TQ, cs, os, r2, sigma, round, mp_feats, mp_bf16, Cmp,
      mp_out);
}

}  // namespace
