// Tensor-core building blocks of the port's kernels (sm_90a): warp
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and m16n8k8 (tf32 in, fp32
// accumulate; three of them make one fp32 product, 3xTF32), ldmatrix and
// cp.async; and the pieces that the tensor-core KPConvs (kpconv_mma.cuh,
// kpconv_tau_mma.cuh, kpconv_transpose_mma.cuh) share: the ordered list of
// a band's active rows, the chunk loader, the aggregation (influence tile
// x row chunk) and the contraction (acc_k x W_k), each in bf16 and in
// 3xTF32.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"), lane = 4 * g + t:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..), a3 = (g+8, 8+2t..)
//   B (16 x 8, k x n):      b0 = (2t..2t+1, g),  b1 = (8+2t.., g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// The lower column (or k) index of a pair sits in the low 16 bits.
// m16n8k8 .tf32 ("mma.m16n8k8"), one element a register:
//   A (16 x 8, row-major): a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)
//   B (8 x 8, k x n):      b0 = (t, g), b1 = (t+4, g)
//   C as above.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kpconv_mma_plan.cuh"

namespace cofii2p {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b on one 16 x 8 tile
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on one 16 x 8 tile, tf32 operands (fp32 bit patterns whose
// low 13 mantissa bits are zero)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi), both rounded
// to nearest (cvt.rna); the difference x - hi is exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

// acc += a * b in fp32 by 3xTF32 (a = ah + al, b = bh + bl, split_tf32):
// al*bh + ah*bl + ah*bh chained from zero in a fresh fragment, then added
// to acc with round-to-nearest.  The tensor cores do not round their fp32
// sum to nearest: chained in acc itself over a 512 x 512 contraction's
// 2880 products, every output came out shrunk toward zero, 2.15e-4 from
// the plain version (H100 80GB HBM3), over the 1e-4 gate.
__device__ __forceinline__ void mma_tf32x3(float* acc, const uint32_t* ah, const uint32_t* al, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two matrices; lanes 0..15 give the row addresses
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, asynchronously; the bytes past ``src_bytes``
// (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// A tensor-core KPConv block: kMmaThreads threads; plan P (MmaPlan or
// TauPlan) gives the chunk rows RB, the shared row strides, and the warp
// tiling: warp (wm, wn) holds MA x NA fragments of the (TQ, CI) aggregate
// from m-tile wm * MA and n-tile wn * NA, and MO x NO of the (TQ, CO)
// output.

// Appends j to the ordered list rows where keep, in row order over the
// block (thread tid holds row base j0 + tid); returns the list's new
// length.  Every thread calls it; warp_tot holds a word per warp; two
// barriers.
template <typename Idx>
__device__ __forceinline__ int append_rows(bool keep, int j, Idx* rows, int base, int* warp_tot, int lane, int warp) {
  const unsigned flags = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_tot[warp] = __popc(flags);
  __syncthreads();
  int off = base, total = 0;
  for (int w = 0; w < kMmaThreads / 32; ++w) {
    if (w < warp) off += warp_tot[w];
    total += warp_tot[w];
  }
  if (keep) rows[off + __popc(flags & ((1u << lane) - 1u))] = static_cast<Idx>(j);
  __syncthreads();
  return base + total;
}

// Whether stage_rows may copy f by 16-byte cp.async into E elements: f is
// already E, a row (and every row stride and offset of the caller's, a
// multiple of Cin) is whole 16-byte pieces, and f is aligned
template <typename E>
__device__ __forceinline__ bool stage_vec(const void* f, int f_bf16, int Cin) {
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  return (f_bf16 != 0) == kBf16 && Cin % (16 / static_cast<int>(sizeof(E))) == 0 &&
         (reinterpret_cast<uintptr_t>(f) & 15) == 0;
}

// The rows listed at [a0, a0 + RB) into a shared slot dst (RB rows of
// P::F_STRIDE elements, CI used): slot row r is row rows[a0 + r] of f (rows
// `stride` elements apart from element frow0, `ncols` of them taken), zero
// past n_act and past ncols; E is bf16 (fp32 values rounded) or fp32.  The
// features of a band take stride = ncols = Cin; the transposed kernel's
// cotangent rows stride = K * C.  One cp.async group.
template <class P, int CI, typename E, typename Idx>
__device__ __forceinline__ void stage_rows(E* dst, const void* f, int f_bf16, bool vec, int ncols, long stride,
                                           long frow0, const Idx* rows, int a0, int n_act, int tid) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(E);
    constexpr int kPieces = CI / kVec;
    for (int i = tid; i < P::RB * kPieces; i += kMmaThreads) {
      const int r = i / kPieces, col = (i % kPieces) * kVec;
      const bool live = a0 + r < n_act && col < ncols;
      const E* src = static_cast<const E*>(f) + (live ? frow0 + (long)rows[a0 + r] * stride + col : 0);
      cp_async16(dst + r * P::F_STRIDE + col, src, live ? 16 : 0);
    }
  } else {
    for (int i = tid; i < P::RB * CI; i += kMmaThreads) {
      const int r = i / CI, col = i % CI;
      float v = 0.f;
      if (a0 + r < n_act && col < ncols) v = load_f(f, frow0 + (long)rows[a0 + r] * stride + col, f_bf16);
      if constexpr (std::is_same<E, float>::value)
        dst[r * P::F_STRIDE + col] = v;
      else
        dst[r * P::F_STRIDE + col] = __float2bfloat16(v);
    }
  }
  cp_async_commit();
}

// acc += A (TQ, RB) @ F (RB, CI), bf16: A_s rows of P::A_STRIDE, Fs rows
// of P::F_STRIDE
template <class P>
__device__ __forceinline__ void aggregate_bf16(float (&acc)[P::MA][P::NA][4], const __nv_bfloat16* A_s,
                                               const __nv_bfloat16* Fs, int wm, int wn, int lane) {
#pragma unroll
  for (int ks = 0; ks < P::RB / 16; ++ks) {
    uint32_t af[P::MA][4];
#pragma unroll
    for (int i = 0; i < P::MA; ++i)
      ldsm_x4(af[i], A_s + ((wm * P::MA + i) * 16 + (lane & 15)) * P::A_STRIDE + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jn = 0; jn < P::NA; ++jn) {
      uint32_t bf[2];
      ldsm_x2_trans(bf, Fs + (ks * 16 + (lane & 15)) * P::F_STRIDE + (wn * P::NA + jn) * 8);
#pragma unroll
      for (int i = 0; i < P::MA; ++i) mma_bf16(acc[i][jn], af[i], bf[0], bf[1]);
    }
  }
}

// acc += A (TQ, RB) @ F (RB, CI) in fp32 by 3xTF32: A already split into
// tf32 A_hi and A_lo (rows of P::A_STRIDE words), F fp32 (rows of
// P::F_STRIDE) split at its fragment loads
template <class P>
__device__ __forceinline__ void aggregate_tf32x3(float (&acc)[P::MA][P::NA][4], const uint32_t* A_hi,
                                                 const uint32_t* A_lo, const float* Fs, int wm, int wn, int g,
                                                 int t4) {
#pragma unroll 1
  for (int ks = 0; ks < P::RB / 8; ++ks) {
    uint32_t ah[P::MA][4], al[P::MA][4];
#pragma unroll
    for (int i = 0; i < P::MA; ++i) {
      const int o = ((wm * P::MA + i) * 16 + g) * P::A_STRIDE + ks * 8 + t4;
      const int offs[4] = {o, o + 8 * P::A_STRIDE, o + 4, o + 8 * P::A_STRIDE + 4};
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[i][e] = A_hi[offs[e]], al[i][e] = A_lo[offs[e]];
    }
#pragma unroll
    for (int jn = 0; jn < P::NA; ++jn) {
      const float* bp = Fs + (ks * 8 + t4) * P::F_STRIDE + (wn * P::NA + jn) * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bp[0], bh0, bl0);
      split_tf32(bp[4 * P::F_STRIDE], bh1, bl1);
#pragma unroll
      for (int i = 0; i < P::MA; ++i) mma_tf32x3(acc[i][jn], ah[i], al[i], bh0, bh1, bl0, bl1);
    }
  }
}

// acc_k from its fragments into P_s as a (TQ, CI) matrix (rows of
// P::P_STRIDE): fp32 kept, or rounded to bf16
template <class P, typename E>
__device__ __forceinline__ void park_acc(E* P_s, const float (&acc)[P::MA][P::NA][4], int wm, int wn, int g,
                                         int t4) {
#pragma unroll
  for (int i = 0; i < P::MA; ++i) {
#pragma unroll
    for (int jn = 0; jn < P::NA; ++jn) {
      const int row = (wm * P::MA + i) * 16 + g, col = (wn * P::NA + jn) * 8 + 2 * t4;
      if constexpr (std::is_same<E, float>::value) {
        *reinterpret_cast<float2*>(P_s + row * P::P_STRIDE + col) = make_float2(acc[i][jn][0], acc[i][jn][1]);
        *reinterpret_cast<float2*>(P_s + (row + 8) * P::P_STRIDE + col) = make_float2(acc[i][jn][2], acc[i][jn][3]);
      } else {
        *reinterpret_cast<uint32_t*>(P_s + row * P::P_STRIDE + col) = pack_bf16(acc[i][jn][0], acc[i][jn][1]);
        *reinterpret_cast<uint32_t*>(P_s + (row + 8) * P::P_STRIDE + col) = pack_bf16(acc[i][jn][2], acc[i][jn][3]);
      }
    }
  }
}

// o += acc_k (TQ, CI) @ W_k (CI, CO), bf16: acc_k parked in P_s, Wk
// (CO, CI) bf16 with Cin permuted within each 32 channels
// (ops/kpconv_kernel.py::mma_weights), so one 16-byte load from L2 is a
// lane's B fragments of two k-steps
template <class P, int CI>
__device__ __forceinline__ void contract_bf16(float (&o)[P::MO][P::NO][4], const __nv_bfloat16* P_s,
                                              const __nv_bfloat16* Wk, int wm, int wn, int g, int t4, int lane) {
#pragma unroll 2
  for (int ks2 = 0; ks2 < CI / 32; ++ks2) {
    uint4 wf[P::NO];
#pragma unroll
    for (int jn = 0; jn < P::NO; ++jn) {
      const int n = (wn * P::NO + jn) * 8 + g;
      wf[jn] = *reinterpret_cast<const uint4*>(Wk + (long)n * CI + ks2 * 32 + t4 * 8);
    }
    uint32_t af[P::MO][2][4];
#pragma unroll
    for (int i = 0; i < P::MO; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4(af[i][h], P_s + ((wm * P::MO + i) * 16 + (lane & 15)) * P::P_STRIDE + (ks2 * 2 + h) * 16 +
                              (lane >> 4) * 8);
#pragma unroll
    for (int jn = 0; jn < P::NO; ++jn) {
#pragma unroll
      for (int i = 0; i < P::MO; ++i) {
        mma_bf16(o[i][jn], af[i][0], wf[jn].x, wf[jn].y);
        mma_bf16(o[i][jn], af[i][1], wf[jn].z, wf[jn].w);
      }
    }
  }
}

// o += acc_k (TQ, CI) @ W_k (CI, CO) in fp32 by 3xTF32: acc_k parked fp32
// in P_s, Wk (CO, CI) fp32 with each 8 channels ordered 0 4 1 5 2 6 3 7
// (ops/kpconv_kernel.py::tf32_weights), so one 8-byte load is a lane's
// (b0, b1) of a k-step; both split at their fragment loads
template <class P, int CI>
__device__ __forceinline__ void contract_tf32x3(float (&o)[P::MO][P::NO][4], const float* P_s, const float* Wk,
                                                int wm, int wn, int g, int t4) {
#pragma unroll 1
  for (int ks = 0; ks < CI / 8; ++ks) {
    uint32_t ah[P::MO][4], al[P::MO][4];
#pragma unroll
    for (int i = 0; i < P::MO; ++i) {
      const float* ap = P_s + ((wm * P::MO + i) * 16 + g) * P::P_STRIDE + ks * 8 + t4;
      split_tf32(ap[0], ah[i][0], al[i][0]);
      split_tf32(ap[8 * P::P_STRIDE], ah[i][1], al[i][1]);
      split_tf32(ap[4], ah[i][2], al[i][2]);
      split_tf32(ap[8 * P::P_STRIDE + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int jn = 0; jn < P::NO; ++jn) {
      const int n = (wn * P::NO + jn) * 8 + g;
      const float2 w = *reinterpret_cast<const float2*>(Wk + (long)n * CI + ks * 8 + 2 * t4);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(w.x, bh0, bl0);
      split_tf32(w.y, bh1, bl1);
#pragma unroll
      for (int i = 0; i < P::MO; ++i) mma_tf32x3(o[i][jn], ah[i], al[i], bh0, bh1, bl0, bl1);
    }
  }
}

// The (TQ, CO) output fragments to out rows of Cout fp32 (the block's
// first query's row at out), the first TQ queries and Cout columns
template <class P>
__device__ __forceinline__ void store_out(float* out, const float (&o)[P::MO][P::NO][4], int Cout, int TQ, int wm,
                                          int wn, int g, int t4) {
#pragma unroll
  for (int i = 0; i < P::MO; ++i) {
#pragma unroll
    for (int jn = 0; jn < P::NO; ++jn) {
      const int col = (wn * P::NO + jn) * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (wm * P::MO + i) * 16 + g + 8 * half;
        if (q >= TQ) continue;
        float* dst = out + (long)q * Cout;
        if (col < Cout) dst[col] = o[i][jn][2 * half];
        if (col + 1 < Cout) dst[col + 1] = o[i][jn][2 * half + 1];
      }
    }
  }
}

}  // namespace cofii2p
