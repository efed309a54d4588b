// Transposed banded KPConv aggregation for Hopper: the feature gradient of
// the banded aggregation, on static bands and on dynamic windows on the
// CUDA cores (kernels #9, #10), and under the k-NN (tau) semantics on the
// tensor cores (kernel #11, kpconv_transpose_mma.cuh, launched here).
//
// Replaces: cofii2p_tpu/ops/kpconv_kernel.py::_transpose_agg (body
// _agg_bwd_kernel).  Same function: for each support row j,
//   g_feats[j, :] = sum_m sum_k infl_k(q_m, s_j) g[m, k, :]
// over the queries m whose static band holds j (start(tile(m)) <= j <
// start(tile(m)) + band) and whose kernel reach holds j (d2 <= r2, centred
// on the first query of m's 128-row band tile, exactly as the forward).
//
// What bounds it on the H100: reading g, the (B, M, 15, C) fp32 cotangent
// of the aggregate (up to 315 MB a call at B = 8), and the 2 * 15 * C
// multiply-adds per in-reach (query, support) pair.  The TPU kernel's plan
// is kept because it needs no atomics and is deterministic: a block owns TS
// support rows and a channel range, and walks the contiguous window of
// query tiles whose bands touch its rows (ops/banded.py::bwd_geometry,
// computed on the host).  For each tile it compacts the tile's queries
// with an in-reach row in the block into an ordered list in shared memory
// (ballots), so only those rows of g are read; per kernel point it
// recomputes the influence of a chunk of listed queries on the block's
// rows into shared memory and adds infl * g[m, k, c] into an accumulator
// of the block's (row, channel) pairs held in registers.  The sum runs in
// a fixed order, so the result is the same from run to run.
//
// With DYN it replaces kpconv_kernel.py::_transpose_agg_dyn (body
// _agg_bwd_dyn_kernel, kernel #10): under per-tile data-dependent window
// starts there is no static plan from support rows to query tiles, so a
// block owns TS rows of ONE query tile's window instead and writes their
// sums to that tile's slice of a (B, num_tiles, band, C) gradient stack,
// every element once; band_scatter.cu then adds the overlapping windows
// in tile order, as the TPU's _scatter_band_stacks does.  No atomics.
//
// Exactness: membership is bit-identical to the forward's (same centring,
// the round-to-nearest intrinsics of common.cuh, the same band mask), so
// no pair is dropped or added; the influence takes
// its offset from the uncentred coordinates, as the forward kernel does;
// sums are fp32 in another order than the plain version's.

#include "common.cuh"
#include "kpconv_transpose_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kE = 32;          // accumulator elements per thread
constexpr int kRB = 32;         // listed queries per influence chunk
constexpr int kMaxTS = 64;      // support rows per block at most
constexpr int kMaxTile = 128;   // queries per band tile at most
constexpr int kAccElems = kThreads * kE;

// A = 0: C padded to a power of two below 256, a thread owns one channel
// and the rows r0 + R * i.  A >= 1: C padded to 256 * A, a thread owns
// channels tid + 256 * a of rows i / A (the forward kernel's layout).
//
// DYN: blockIdx.x = t * (band / TS) + chunk, the block owns rows chunk * TS
// .. of tile t's window and writes them to the stack ``out``.
template <int A, bool DYN>
__global__ void __launch_bounds__(kThreads) kpconv_transpose_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const float* __restrict__ g, const float* __restrict__ kp,
    const int* __restrict__ starts, const int* __restrict__ qstart_blk,
    float* __restrict__ out, int M, int N,
    int C, int K, int tile, int num_tiles, int band, int TS, int n_qtiles,
    int c_shift, float r2, float sigma, int round) {
  __shared__ float sp_s[kMaxTS * 3];   // the block's support rows
  __shared__ float pc_s[kMaxTS * 3];   // ... centred on the tile's first query
  __shared__ float qa_s[kMaxTile * 3]; // listed queries, centred
  __shared__ float qr_s[kMaxTile * 3]; // ... uncentred, for the influence
  __shared__ int act[kMaxTile];        // listed queries, absolute index
  __shared__ int warp_tot[kThreads / 32];
  __shared__ float work[kMaxTS * kRB]; // influence of a chunk on the rows

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  // DYN: the block's window (tile t_first) and its first row there
  const int per_tile = DYN ? band / TS : 1;
  const int t_first = DYN ? blockIdx.x / per_tile : qstart_blk[blockIdx.x];
  const int row0 = DYN ? (blockIdx.x % per_tile) * TS : 0;
  const int s0 = DYN ? starts[b * num_tiles + t_first] + row0 : blockIdx.x * TS;
  if (DYN) n_qtiles = 1;

  for (int i = tid; i < TS * 3; i += kThreads) sp_s[i] = s_pts[((long)b * N + s0) * 3 + i];

  const int c_mask = (1 << c_shift) - 1;
  const int R = A == 0 ? (kThreads >> c_shift) : 0;
  const int r_0 = A == 0 ? (tid >> c_shift) : 0;
  float acc[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) acc[i] = 0.f;

  for (int tt = 0; tt < n_qtiles; ++tt) {
    const int t = t_first + tt;
    if (t >= num_tiles) break;
    const int start = starts[b * num_tiles + t];
    // rows lo..hi of the block lie in tile t's band
    const int lo = max(start - s0, 0), hi = min(start + band - s0, TS);
    if (lo >= hi) continue;
    const float* ref_p = q_pts + ((long)b * M + (long)t * tile) * 3;
    __syncthreads();  // the previous tile is done with pc_s, act, qa_s
    for (int i = tid; i < TS * 3; i += kThreads) pc_s[i] = __fsub_rn(sp_s[i], ref_p[i % 3]);
    __syncthreads();

    // ordered list of the tile's queries with an in-reach row in lo..hi
    bool any = false;
    float qc[3] = {0.f, 0.f, 0.f}, qr[3] = {0.f, 0.f, 0.f};
    const int m = t * tile + tid;
    if (tid < tile) {
      for (int d = 0; d < 3; ++d) {
        qr[d] = q_pts[((long)b * M + m) * 3 + d];
        qc[d] = __fsub_rn(qr[d], ref_p[d]);
      }
      for (int r = lo; r < hi && !any; ++r) {
        const float d2 = cofii2p::membership_d2(qc, pc_s[3 * r], pc_s[3 * r + 1], pc_s[3 * r + 2]);
        any = d2 <= r2;
      }
    }
    const unsigned flags = __ballot_sync(0xffffffffu, any);
    if (lane == 0) warp_tot[warp] = __popc(flags);
    __syncthreads();
    int off = 0, n_act = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) off += warp_tot[w];
      n_act += warp_tot[w];
    }
    if (any) {
      const int idx = off + __popc(flags & ((1u << lane) - 1u));
      act[idx] = m;
      for (int d = 0; d < 3; ++d) {
        qa_s[3 * idx + d] = qc[d];
        qr_s[3 * idx + d] = qr[d];
      }
    }
    __syncthreads();

    for (int k = 0; k < K; ++k) {
      const float kx = kp[k * 3], ky = kp[k * 3 + 1], kz = kp[k * 3 + 2];
      for (int a0 = 0; a0 < n_act; a0 += kRB) {
        const int na = min(kRB, n_act - a0);
        for (int idx = tid; idx < TS * kRB; idx += kThreads) {
          const int s = idx / kRB, r = idx % kRB;
          float v = 0.f;
          if (r < na && s >= lo && s < hi) {
            const float* q = qa_s + 3 * (a0 + r);
            const float* p = pc_s + 3 * s;
            const float d2 = cofii2p::membership_d2(q, p[0], p[1], p[2]);
            if (d2 <= r2) {
              const float* qa = qr_s + 3 * (a0 + r);
              const float* pa = sp_s + 3 * s;
              const float dx = (pa[0] - qa[0]) - kx;
              const float dy = (pa[1] - qa[1]) - ky;
              const float dz = (pa[2] - qa[2]) - kz;
              v = fmaxf(1.f - sqrtf(dx * dx + dy * dy + dz * dz) / sigma, 0.f);
              if (round) v = cofii2p::round_bf16(v);
            }
          }
          work[s * kRB + r] = v;
        }
        __syncthreads();
        for (int r = 0; r < na; ++r) {
          const long grow = (((long)b * M + act[a0 + r]) * K + k) * C;
          if (A == 0) {
            const int c = tid & c_mask;
            float gv = c < C ? g[grow + c] : 0.f;
            if (round) gv = cofii2p::round_bf16(gv);
#pragma unroll
            for (int i = 0; i < kE; ++i) {
              const int s = r_0 + R * i;
              if (s < TS) acc[i] += work[s * kRB + r] * gv;
            }
          } else {
            float gv[A > 0 ? A : 1];
#pragma unroll
            for (int a = 0; a < A; ++a) {
              const int c = tid + kThreads * a;
              gv[a] = c < C ? g[grow + c] : 0.f;
              if (round) gv[a] = cofii2p::round_bf16(gv[a]);
            }
#pragma unroll
            for (int i = 0; i < kE; ++i) {
              const int s = i / (A > 0 ? A : 1);
              if (s < TS) acc[i] += work[s * kRB + r] * gv[i % (A > 0 ? A : 1)];
            }
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kE; ++i) {
    int s, c;
    if (A == 0) {
      s = r_0 + R * i;
      c = tid & c_mask;
    } else {
      s = i / (A > 0 ? A : 1);
      c = tid + kThreads * (i % (A > 0 ? A : 1));
    }
    if (s < TS && c < C) {
      const long row = DYN ? ((long)b * num_tiles + t_first) * band + row0 + s : (long)b * N + s0 + s;
      out[row * C + c] = acc[i];
    }
  }
}

int log2_pad(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

// The two modes' checks and launch; DYN ignores qstart_blk and n_qtiles.
template <bool DYN>
int launch(const void* q, const void* s, const void* g, const void* kp,
           const void* starts, const void* qstart_blk,
           void* out, int B, int M, int N, int C, int K, int tile,
           int num_tiles, int band, int TS, int n_qtiles, int round, float r2,
           float sigma, void* stream) {
  const int cs = log2_pad(C);
  const int A = cs < 8 ? 0 : 1 << (cs - 8);
  const int rows = DYN ? band : N;
  if (A > 2 || TS < 1 || TS > kMaxTS || rows % TS || (TS << cs) > kAccElems ||
      tile < 1 || tile > kMaxTile || M % tile || M / tile != num_tiles || band > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(DYN ? num_tiles * (band / TS) : N / TS, B);
  auto st = static_cast<cudaStream_t>(stream);
#define COFII2P_LAUNCH(a)                                                       \
  if (A == a)                                                                   \
    kpconv_transpose_kernel<a, DYN><<<grid, kThreads, 0, st>>>(                 \
        static_cast<const float*>(q), static_cast<const float*>(s),             \
        static_cast<const float*>(g), static_cast<const float*>(kp),            \
        static_cast<const int*>(starts), static_cast<const int*>(qstart_blk),   \
        static_cast<float*>(out), M, N, C, K, tile, num_tiles, band, TS,        \
        n_qtiles, cs, r2, sigma, round);
  COFII2P_LAUNCH(0)
  COFII2P_LAUNCH(1)
  COFII2P_LAUNCH(2)
#undef COFII2P_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, M, 3), s (B, N, 3), g (B, M, K, C) fp32, kp (K, 3) fp32, starts
// (B, num_tiles) int32 static band starts, qstart_blk (N / TS) int32 first
// query tile of each support tile's window of n_qtiles tiles; out (B, N, C)
// fp32.  TS divides N, TS <= 64, TS * pad(C) <= 8192, tile <= 128.
extern "C" int kpconv_transpose_launch(
    const void* q, const void* s, const void* g, const void* kp,
    const void* starts, const void* qstart_blk, void* out, int B, int M,
    int N, int C, int K, int tile, int num_tiles, int band, int TS,
    int n_qtiles, int round, float r2, float sigma, void* stream) {
  return launch<false>(q, s, g, kp, starts, qstart_blk, out, B, M, N, C, K, tile, num_tiles, band, TS, n_qtiles,
                       round, r2, sigma, stream);
}

// Kernel #10's stack: q, s, g, kp as above, starts (B, num_tiles) int32
// dynamic window starts of width band; stack (B, num_tiles, band, C) fp32,
// each tile's window rows' gradient (band_scatter.cu adds them up).
// TS divides band.
extern "C" int kpconv_transpose_dyn_launch(
    const void* q, const void* s, const void* g, const void* kp,
    const void* starts, void* stack, int B, int M, int N, int C, int K,
    int tile, int num_tiles, int band, int TS, int round, float r2,
    float sigma, void* stream) {
  return launch<true>(q, s, g, kp, starts, nullptr, stack, B, M, N, C, K, tile, num_tiles, band, TS, 1, round, r2,
                      sigma, stream);
}

// Kernel #11 on the tensor cores (kpconv_transpose_mma.cuh): as
// kpconv_transpose_launch with tau (B, M) fp32 the per-query squared k-NN
// thresholds, kp the layer's own kernel points and r2 the padded reach.
// TS divides N, TS <= 64 (TransposePlan), tile <= 128, C <= 512; fp32
// compute (round = 0) by 3xTF32, bf16 (round = 1) rounds the influence
// and g to bf16 before their product.
extern "C" int kpconv_transpose_tau_launch(
    const void* q, const void* s, const void* g, const void* kp,
    const void* starts, const void* qstart_blk, const void* tau, void* out,
    int B, int M, int N, int C, int K, int tile, int num_tiles, int band,
    int TS, int n_qtiles, int round, float r2, float sigma, void* stream) {
  const cofii2p::TransposeArgs a{static_cast<const float*>(q), static_cast<const float*>(s),
                                 static_cast<const float*>(g), static_cast<const float*>(kp),
                                 static_cast<const int*>(starts), static_cast<const int*>(qstart_blk),
                                 static_cast<const float*>(tau), static_cast<float*>(out),
                                 B, M, N, C, K, tile, num_tiles, band, TS, n_qtiles, r2, sigma,
                                 static_cast<cudaStream_t>(stream)};
  const TauMember member{static_cast<const float*>(tau)};
  return round ? launch_transpose_widths<false>(a, member) : launch_transpose_widths<true>(a, member);
}
