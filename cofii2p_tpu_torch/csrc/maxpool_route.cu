// The routing of the banded maxpool's backward for Hopper: kernels #13
// (radius membership, static bands), #14 (radius membership, dynamic
// windows) and #15 (k-NN membership, static bands), one kernel.
//
// Replaces: cofii2p_tpu/ops/maxpool_kernel.py::_bwd (body
// _maxpool_bwd_kernel, #13), ::_bwd_dyn (body _mp_bwd_dyn_kernel, #14) and
// ::_tau_bwd (body _maxpool_bwd_kernel_tau, #15).  For each support row j
// and channel c,
//   g_feats[j, c] = sum_m gs[m, c] * [j in m's neighbourhood] * [f[j, c] == out[m, c]]
// where the neighbourhood is the forward's (maxpool_fwd.cu): j in the band
// of m's 128-query tile (static, or the tile's dynamic window for #14)
// and, centred on that tile's first query, d2 <= r2 (#3's radius, for #13
// and #14) or d2 <= tau[m] with no radius mask (#8's, for #15); gs is the
// cotangent already divided by max(tie count, 1) (#12), so exact
// duplicates split it evenly, and out is the forward's output.
//
// What bounds it on the H100: moving out and gs, (B, M, C) each, to every
// support row that a query holds.  A query holds tens (radius) to ~128
// (k-NN) rows, so a kernel that reads out[m, c] and gs[m, c] per (row,
// member query, channel) from global memory reads them that many times
// over.  The design (plan RoutePlan in maxpool_plan.cuh) follows the
// transposed KPConv (kpconv_transpose_mma.cuh):
//  - static bands: a block owns TS = 64 support rows and every channel,
//    and walks the window of query tiles whose bands touch its rows
//    (ops/banded.py::bwd_geometry, on the host);
//  - windows (WINDOW, #14): a block owns TS rows of one query tile's
//    dynamic window (its start read on the device), so its window of
//    query tiles is that one tile, and it writes its rows' sums to the
//    tile's slice of a (B, num_tiles, band, C) stack, each element once;
//    band_scatter.cu adds the overlapping windows up in tile order;
//  - membership is tested once a block: each (window query, row) pair
//    once, kept as a 64-bit word a query (a bit a row), and the queries
//    with any bit listed in query order; the member test is a policy
//    (RadiusMember for #13/#14, TauOnly for #15);
//  - the channels go in slices of CS = 128: the listed queries' out and gs
//    slices are staged into shared memory by cp.async, 32 queries a
//    chunk, two chunks in flight, each read from global memory once per
//    (block, slice);
//  - warp w owns rows [4 w, 4 w + 4), a lane 4 channels of each: the rows'
//    features and sums stay in registers.  For each chunk a warp ballots
//    which of its 32 queries hold any of its rows, then for each such
//    query reads the lane's out and gs from shared memory once and adds
//    gs where a held row's feature equals out.
// Each (row, channel) sum (WINDOW: each stack entry) is taken by one
// thread in query order (tiles ascending, then queries), in fp64, and
// rounded to fp32 once, with no atomics: the same bits on every launch.
// A row that is the maximum of many queries (a dense level, k = 128) sums
// ~64 terms; summed in fp32 in query order, such sums on the densest
// shortcut (encoder2_1) strayed from the plain version's per-tile fp32
// sums by more than the 1e-5 (rms-relative) gate.
//
// Exactness: membership is bit-identical to the forward's (the same
// centring on the tile's first query, cofii2p::membership_d2 with the
// round-to-nearest intrinsics of common.cuh, and the same threshold), so
// no maximum loses its gradient and no tied row gets a share it did not
// earn; features and out are compared in fp32 (bf16 widened exactly);
// each sum is within half an fp32 ulp of the exact one, the plain
// version's fp32 sums the farther from it.

#include "maxpool_plan.cuh"
#include "mma.cuh"

namespace {

using cofii2p::RoutePlan;

// Radius membership of a (query, support row) pair: within the forward's
// r2 (#13 and #14, as the forward #3)
struct RadiusMember {
  float r2;
  __device__ __forceinline__ float threshold(long) const { return r2; }
  __device__ __forceinline__ bool member(float d2, float thr) const { return d2 <= thr; }
};

// k-NN membership of a (query, support row) pair: within the query's tau,
// no radius mask (#15, as the forward #8)
struct TauOnly {
  const float* tau;
  __device__ __forceinline__ float threshold(long bm) const { return tau[bm]; }
  __device__ __forceinline__ bool member(float d2, float thr) const { return d2 <= thr; }
};

// The membership word of window query jq of the segment
__device__ __forceinline__ unsigned long long word_of(const unsigned long long* bits_s, int jq, int tile) {
  return bits_s[jq];
}

// Window queries [mseg, mseg + nq) of tiles tseg.. (whole tiles): each
// (query, row half) item tests the half's 32 rows of the block against the
// query, d2 centred on the query's tile's first query; then the queries
// with any bit are listed in query order (list_s, relative to mseg).
// Every thread calls it; returns the list's length.
template <class P, class Member>
__device__ int route_membership(const float* q_pts, const int* starts, const float* sp_s, const Member& member,
                                int b, int M, int num_tiles, int tile, int band, int s0, int TS, int tseg, int nq,
                                unsigned long long* bits_s, unsigned short* list_s, int* cnt_s, int tid, int lane,
                                int warp) {
  unsigned* half_s = reinterpret_cast<unsigned*>(bits_s);  // word 2 jq + h: rows 32 h .. 32 h + 31
  for (int idx = tid; idx < 2 * nq; idx += P::THREADS) {
    const int jq = idx % nq, h = idx / nq;
    const int t = tseg + jq / tile, q = jq % tile;
    const int start = starts[b * num_tiles + t];
    // rows lo..hi of the block lie in tile t's band
    const int lo = max(start - s0, 0), hi = min(start + band - s0, TS);
    const long m_ref = (long)b * M + (long)t * tile;
    const float rx = q_pts[m_ref * 3], ry = q_pts[m_ref * 3 + 1], rz = q_pts[m_ref * 3 + 2];
    const int qm = t * tile + q;
    const long bm = (long)b * M + qm;
    const float qc[3] = {__fsub_rn(q_pts[bm * 3], rx), __fsub_rn(q_pts[bm * 3 + 1], ry),
                         __fsub_rn(q_pts[bm * 3 + 2], rz)};
    const float thr = member.threshold(bm);
    unsigned w = 0u;
    const int r_lo = max(lo - 32 * h, 0), r_hi = min(hi - 32 * h, 32);
    for (int r = r_lo; r < r_hi; ++r) {
      const float* p = sp_s + 3 * (32 * h + r);
      const float d2 = cofii2p::membership_d2(qc, __fsub_rn(p[0], rx), __fsub_rn(p[1], ry), __fsub_rn(p[2], rz));
      if (member.member(d2, thr)) w |= 1u << r;
    }
    half_s[2 * jq + h] = w;
  }
  __syncthreads();
  int base = 0;
  for (int i0 = 0; i0 < nq; i0 += P::THREADS) {
    const int jq = i0 + tid;
    const bool keep = jq < nq && word_of(bits_s, jq, tile) != 0ull;
    const unsigned flags = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) cnt_s[warp] = __popc(flags);
    __syncthreads();
    int off = base, total = 0;
#pragma unroll
    for (int w = 0; w < P::WARPS; ++w) {
      if (w < warp) off += cnt_s[w];
      total += cnt_s[w];
    }
    if (keep) list_s[off + __popc(flags & ((1u << lane) - 1u))] = static_cast<unsigned short>(jq);
    base += total;
    __syncthreads();
  }
  return base;
}

// Listed queries [32 k, 32 k + 32) of the segment, the out and gs slices
// of channels [c0, c0 + CS), into slot dst (a query's out slice, then its
// gs slice): one cp.async group.  vec: whole 16-byte pieces (C a multiple
// of 16 / ESZ, pointers aligned); otherwise element by element.
template <class P, int ESZ>
__device__ __forceinline__ void stage_queries(unsigned char* dst, const unsigned char* pooled, const float* gs,
                                              bool vec, long mrow0, int C, int c0, const unsigned short* list_s,
                                              int k, int n_list, int tid) {
  for (int i = tid; i < P::RB * P::PIECES; i += P::THREADS) {
    const int r = i / P::PIECES, piece = i % P::PIECES;
    const int p = P::RB * k + r;
    if (p >= n_list) continue;
    const bool is_out = piece < P::OUT_PIECES;
    const int esz = is_out ? ESZ : 4;
    const int c = c0 + (is_out ? piece : piece - P::OUT_PIECES) * (16 / esz);
    if (c >= C) continue;
    const long e = (mrow0 + list_s[p]) * C + c;
    const unsigned char* src = is_out ? pooled + e * ESZ : reinterpret_cast<const unsigned char*>(gs + e);
    unsigned char* d = dst + r * P::QROW_BYTES + piece * 16;
    if (vec) {
      cofii2p::cp_async16(d, src, 16);
    } else {
      for (int x = 0; x < 16 / esz && c + x < C; ++x)
        for (int y = 0; y < esz; ++y) d[x * esz + y] = src[x * esz + y];
    }
  }
  cofii2p::cp_async_commit();
}

// A lane's 4 channels of a row of f (fp32, or bf16 widened), from global
// memory (vec: one 16- or 8-byte load) or shared memory
template <bool BF16>
__device__ __forceinline__ void load4(const unsigned char* p, bool vec, int n, float (&v)[4]) {
  if (vec) {
    if constexpr (BF16) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(w.x << 16), v[1] = __uint_as_float(w.x & 0xffff0000u);
      v[2] = __uint_as_float(w.y << 16), v[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      const float4 w = *reinterpret_cast<const float4*>(p);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    }
    return;
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    v[x] = 0.f;
    if (x < n)
      v[x] = BF16 ? __uint_as_float(static_cast<unsigned>(reinterpret_cast<const unsigned short*>(p)[x]) << 16)
                  : reinterpret_cast<const float*>(p)[x];
  }
}

// grid (N / TS, B), or (num_tiles * band / TS, B) in WINDOW mode; P's
// threads and shared memory.  qstart_blk (N / TS): each block's first
// query tile of its window of n_qtiles tiles (not read in WINDOW mode);
// nslice channel slices of CS.  WINDOW: blockIdx.x = t * (band / TS) +
// chunk owns rows chunk * TS .. of tile t's window, and g_feats is the
// (B, num_tiles, band, C) stack.
template <bool BF16, bool WINDOW, class Member>
__global__ void __launch_bounds__(cofii2p::kRouteThreads, 1) maxpool_route_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts, const void* __restrict__ feats,
    const void* __restrict__ pooled, const float* __restrict__ gs, const int* __restrict__ starts,
    const int* __restrict__ qstart_blk, float* __restrict__ g_feats, int M, int N, int C, int tile, int num_tiles,
    int band, int TS, int n_qtiles, int nslice, int vec, const Member member) {
  constexpr int ESZ = BF16 ? 2 : 4;
  using P = RoutePlan<ESZ>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage_s = smem;  // [slot][RB][out slice | gs slice]
  unsigned long long* bits_s = reinterpret_cast<unsigned long long*>(smem + P::STAGE_BYTES);
  unsigned short* list_s = reinterpret_cast<unsigned short*>(smem + P::STAGE_BYTES + P::BITS_BYTES);
  float* sp_s = reinterpret_cast<float*>(smem + P::STAGE_BYTES + P::BITS_BYTES + P::LIST_BYTES);
  int* cnt_s = reinterpret_cast<int*>(smem + P::STAGE_BYTES + P::BITS_BYTES + P::LIST_BYTES + P::S_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  // the block's support rows s0 .. s0 + TS and its query tiles t_first ..
  // t_end; WINDOW: rows wrow0 .. wrow0 + TS of tile t_first's window, so
  // every row lies in that tile's band (lo = 0, hi = TS below)
  const int per_tile = WINDOW ? band / TS : 1;
  const int t_first = WINDOW ? blockIdx.x / per_tile : qstart_blk[blockIdx.x];
  const int wrow0 = WINDOW ? (blockIdx.x % per_tile) * TS : 0;
  const int s0 = WINDOW ? starts[b * num_tiles + t_first] + wrow0 : blockIdx.x * TS;
  const int t_end = WINDOW ? t_first + 1 : min(t_first + n_qtiles, num_tiles);
  // the first output row: g_feats[b, s0] or stack[b, t_first, wrow0]
  const long orow0 = WINDOW ? ((long)b * num_tiles + t_first) * band + wrow0 : (long)b * N + s0;
  const int tiles_per_seg = P::QSEG / tile;
  const int nseg = (t_end - t_first + tiles_per_seg - 1) / tiles_per_seg;
  const int row0 = warp * P::RPW;  // the warp's rows of the block
  const unsigned char* f = static_cast<const unsigned char*>(feats);
  const unsigned char* pool = static_cast<const unsigned char*>(pooled);

  for (int i = tid; i < P::TS * 3; i += P::THREADS) sp_s[i] = i < TS * 3 ? s_pts[((long)b * N + s0) * 3 + i] : 0.f;
  __syncthreads();

  int n_list = 0;
  for (int sl = 0; sl < nslice; ++sl) {
    const int c0 = sl * P::CS, c = c0 + lane * P::VEC;
    const int nc = min(P::VEC, C - c);  // the lane's channels (<= 0: none)
    float fv[P::RPW][P::VEC];
    double acc[P::RPW][P::VEC];
#pragma unroll
    for (int r = 0; r < P::RPW; ++r) {
#pragma unroll
      for (int x = 0; x < P::VEC; ++x) fv[r][x] = 0.f, acc[r][x] = 0.0;
      if (row0 + r < TS && nc > 0)
        load4<BF16>(f + (((long)b * N + s0 + row0 + r) * C + c) * ESZ, vec, nc, fv[r]);
    }
    for (int sg = 0; sg < nseg; ++sg) {
      const int tseg = t_first + sg * tiles_per_seg;
      const int nq = (min(t_end, tseg + tiles_per_seg) - tseg) * tile;
      if (nseg > 1 || sl == 0) {
        __syncthreads();  // the previous walk is done with the words, the list and the staged chunks
        n_list = route_membership<P>(q_pts, starts, sp_s, member, b, M, num_tiles, tile, band, s0, TS, tseg, nq,
                                     bits_s, list_s, cnt_s, tid, lane, warp);
      }
      const long mrow0 = (long)b * M + (long)tseg * tile;
      const int nchunks = (n_list + P::RB - 1) / P::RB;
      if (nchunks) stage_queries<P, ESZ>(stage_s, pool, gs, vec, mrow0, C, c0, list_s, 0, n_list, tid);
      for (int k = 0; k < nchunks; ++k) {
        if (k + 1 < nchunks) {
          stage_queries<P, ESZ>(stage_s + ((k + 1) & 1) * P::RB * P::QROW_BYTES, pool, gs, vec, mrow0, C, c0,
                                list_s, k + 1, n_list, tid);
          cofii2p::cp_async_wait<1>();
        } else {
          cofii2p::cp_async_wait<0>();
        }
        __syncthreads();
        const unsigned char* buf = stage_s + (k & 1) * P::RB * P::QROW_BYTES;
        // lane i: the chunk's listed query i and which of the warp's rows it holds
        const int p = P::RB * k + lane;
        const unsigned mine =
            p < n_list ? static_cast<unsigned>(word_of(bits_s, list_s[p], tile) >> row0) & ((1u << P::RPW) - 1u)
                       : 0u;
        unsigned held = __ballot_sync(0xffffffffu, mine != 0u);
        while (held) {
          const int i = __ffs(held) - 1;
          held &= held - 1u;
          const unsigned rows = __shfl_sync(0xffffffffu, mine, i);
          float o[P::VEC], g[P::VEC];
          load4<BF16>(buf + i * P::QROW_BYTES + lane * P::VEC * ESZ, true, P::VEC, o);
          load4<false>(buf + i * P::QROW_BYTES + P::OUT_BYTES + lane * P::VEC * 4, true, P::VEC, g);
          double gd[P::VEC];  // widened once a query, not once a held row
#pragma unroll
          for (int x = 0; x < P::VEC; ++x) gd[x] = g[x];
#pragma unroll
          for (int r = 0; r < P::RPW; ++r) {
            if (!((rows >> r) & 1u)) continue;
#pragma unroll
            for (int x = 0; x < P::VEC; ++x) acc[r][x] += fv[r][x] == o[x] ? gd[x] : 0.0;
          }
        }
        __syncthreads();  // every warp is done with slot k & 1 before chunk k + 2 lands there
      }
    }
    // the slice's sums: every (row, channel) of the block once, 0 where no
    // query routed to it
#pragma unroll
    for (int r = 0; r < P::RPW; ++r) {
      if (row0 + r >= TS || nc <= 0) continue;
      float* dst = g_feats + (orow0 + row0 + r) * C + c;
      float sum[P::VEC];
#pragma unroll
      for (int x = 0; x < P::VEC; ++x) sum[x] = static_cast<float>(acc[r][x]);
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(sum[0], sum[1], sum[2], sum[3]);
      } else {
#pragma unroll
        for (int x = 0; x < P::VEC; ++x)
          if (x < nc) dst[x] = sum[x];
      }
    }
  }
}

template <bool BF16, bool WINDOW, class Member>
int launch_route(const void* q, const void* s, const void* f, const void* pooled, const void* gs, const void* starts,
                 const void* qstart_blk, void* g_feats, int B, int M, int N, int C, int tile, int num_tiles, int band,
                 int TS, int n_qtiles, const Member& member, cudaStream_t stream) {
  using P = RoutePlan<BF16 ? 2 : 4>;
  auto kern = maxpool_route_kernel<BF16, WINDOW, Member>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int esz = BF16 ? 2 : 4;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = C % (16 / esz) == 0 && aligned(f) && aligned(pooled) && aligned(gs) && aligned(g_feats);
  const int blocks = WINDOW ? num_tiles * (band / TS) : N / TS;
  kern<<<dim3(blocks, B), P::THREADS, P::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(s), f, pooled, static_cast<const float*>(gs),
      static_cast<const int*>(starts), static_cast<const int*>(qstart_blk), static_cast<float*>(g_feats), M, N, C,
      tile, num_tiles, band, TS, n_qtiles, cofii2p::pool_slices(C, P::CS), vec, member);
  return static_cast<int>(cudaGetLastError());
}

// The checks every launcher makes (WINDOW: TS divides the window width
// band, else N), then the build of the features' dtype.  Refused shapes
// return cudaErrorInvalidValue before anything runs.
template <bool WINDOW, class Member>
int route(const void* q, const void* s, const void* f, int f_bf16, const void* pooled, const void* gs,
          const void* starts, const void* qstart_blk, void* g_feats, int B, int M, int N, int C, int tile,
          int num_tiles, int band, int TS, int n_qtiles, const Member& member, void* stream) {
  if (TS < 1 || TS > cofii2p::kRouteTS || (WINDOW ? band : N) % TS || tile < 1 || tile > 128 || M % tile ||
      M / tile != num_tiles || band < 1 || band > N || C < 1 || n_qtiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || num_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_bf16)
    return launch_route<true, WINDOW>(q, s, f, pooled, gs, starts, qstart_blk, g_feats, B, M, N, C, tile,
                                      num_tiles, band, TS, n_qtiles, member, st);
  return launch_route<false, WINDOW>(q, s, f, pooled, gs, starts, qstart_blk, g_feats, B, M, N, C, tile, num_tiles,
                                     band, TS, n_qtiles, member, st);
}

}  // namespace

// Kernel #13.  q (B, M, 3), s (B, N, 3) fp32; f (B, N, C) and pooled
// (B, M, C), the forward's input and output, fp32 or bf16; gs (B, M, C)
// fp32 cotangent divided by the tie count; starts (B, num_tiles) int32
// static band starts; qstart_blk (N / TS) int32 first query tile of each
// support tile's window of n_qtiles tiles; g_feats (B, N, C) fp32; r2 the
// forward's squared radius.  TS divides N, TS <= 64, tile <= 128; other
// shapes are refused before anything runs.
extern "C" int maxpool_bwd_launch(const void* q, const void* s, const void* f, int f_bf16, const void* pooled,
                                  const void* gs, const void* starts, const void* qstart_blk, void* g_feats, int B,
                                  int M, int N, int C, int tile, int num_tiles, int band, int TS, int n_qtiles,
                                  float r2, void* stream) {
  return route<false>(q, s, f, f_bf16, pooled, gs, starts, qstart_blk, g_feats, B, M, N, C, tile, num_tiles, band,
                      TS, n_qtiles, RadiusMember{r2}, stream);
}

// Kernel #14's stack: q, s, f, pooled, gs and r2 as above; starts
// (B, num_tiles) int32 dynamic window starts of width band (each in
// [0, N - band]); stack (B, num_tiles, band, C) fp32, every element
// written (band_scatter.cu adds it up).  TS divides band, TS <= 64.
extern "C" int maxpool_bwd_dyn_launch(const void* q, const void* s, const void* f, int f_bf16, const void* pooled,
                                      const void* gs, const void* starts, void* stack, int B, int M, int N, int C,
                                      int tile, int num_tiles, int band, int TS, float r2, void* stream) {
  return route<true>(q, s, f, f_bf16, pooled, gs, starts, nullptr, stack, B, M, N, C, tile, num_tiles, band, TS, 1,
                     RadiusMember{r2}, stream);
}

// Kernel #15.  q, s, f, pooled, gs, starts, qstart_blk and g_feats as
// #13's; tau (B, M) fp32 the per-query squared k-NN thresholds.  TS
// divides N, TS <= 64, tile <= 128.
extern "C" int maxpool_bwd_tau_launch(const void* q, const void* s, const void* f, int f_bf16, const void* pooled,
                                      const void* gs, const void* starts, const void* qstart_blk, const void* tau,
                                      void* g_feats, int B, int M, int N, int C, int tile, int num_tiles, int band,
                                      int TS, int n_qtiles, void* stream) {
  return route<false>(q, s, f, f_bf16, pooled, gs, starts, qstart_blk, g_feats, B, M, N, C, tile, num_tiles, band,
                      TS, n_qtiles, TauOnly{static_cast<const float*>(tau)}, stream);
}
