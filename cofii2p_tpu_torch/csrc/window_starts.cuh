// The arithmetic of kernel #19 (window_starts.cu), apart from the kernel:
// each step a thread takes in one (frame, query tile) block.  Plain C++
// with CUDA's rounding intrinsics, so that a host compiler builds it too,
// given those intrinsics (tests/window_starts_host.cc, which runs the
// block's threads one after another).
//
// What a block computes is ops/banded.py::_best_windows for one tile:
//  - membership: d2 of (query, sampled row) with both points centred on the
//    tile's first query, per dimension diff = qc - pc, sq = diff * diff,
//    d2 = (sq0 + sq1) + sq2, every operation rounded on its own (the _rn
//    intrinsics forbid contraction), then d2 <= the query's threshold;
//  - the count of member queries of each sampled row (rows 0, stride,
//    2 stride, ...), kept as 16 bits a row in shared memory;
//  - each width-w_sub window's count, as differences of the prefix sums:
//    the rows split into kThreads chunks of `chunk` rows, a thread's chunk
//    sum, their exclusive scan (`part`, part[kThreads] the total), then each
//    thread walks the window positions of its own chunk with two running
//    prefix sums, P(x) and P(x + w_sub), keeping the first largest;
//  - the block's best window (larger count, then the smaller position: the
//    first maximum, as torch.argmax takes it) times the stride, or the
//    static proportional start where no sampled row is a member; clamped to
//    [0, N - width].
#pragma once

namespace window_starts {

constexpr int kThreads = 256;
// queries of a tile the block stages (16 bytes each) and sampled rows whose
// counts (2 bytes each) fit beside them in shared memory; ops/window_kernel.py
// copies both
constexpr int kMaxTile = 1024;
constexpr int kMaxRows = 98304;

// a query centred on its tile's first query, with its threshold
struct alignas(16) Query {
  float x, y, z, thr;
};

// the window with the most member pairs so far: its count and position
struct Best {
  int v, i;
};

// the sampled rows, the window's width in them, and the rows a thread's
// chunk holds
struct Geometry {
  int n_sub, w_sub, chunk, width;
};

__host__ __device__ __forceinline__ Geometry geometry(int N, int stride, int width) {
  Geometry g;
  g.width = width < N ? width : N;
  g.n_sub = (N + stride - 1) / stride;
  g.w_sub = g.width / stride > 1 ? g.width / stride : 1;
  g.chunk = (g.n_sub + kThreads - 1) / kThreads;
  return g;
}

__device__ __forceinline__ Query centred(const float* q, float rx, float ry, float rz, float thr) {
  return Query{__fsub_rn(q[0], rx), __fsub_rn(q[1], ry), __fsub_rn(q[2], rz), thr};
}

// member queries of the tile for the support row p
__device__ __forceinline__ int row_count(const Query* qs, int tile, const float* p, float rx, float ry, float rz) {
  const float px = __fsub_rn(p[0], rx), py = __fsub_rn(p[1], ry), pz = __fsub_rn(p[2], rz);
  int c = 0;
#pragma unroll 4
  for (int i = 0; i < tile; ++i) {
    const Query v = qs[i];
    const float d0 = __fsub_rn(v.x, px);
    const float d1 = __fsub_rn(v.y, py);
    const float d2 = __fsub_rn(v.z, pz);
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
    c += s <= v.thr ? 1 : 0;
  }
  return c;
}

// the first row of chunk k, at most n_sub
__host__ __device__ __forceinline__ int chunk_start(int k, const Geometry& g) {
  const long long r = static_cast<long long>(k) * g.chunk;
  return r < g.n_sub ? static_cast<int>(r) : g.n_sub;
}

__device__ __forceinline__ int chunk_sum(const unsigned short* cnt, int k, const Geometry& g) {
  const int a = chunk_start(k, g), e = chunk_start(k + 1, g);
  int sum = 0;
  for (int j = a; j < e; ++j) sum += cnt[j];
  return sum;
}

// the first best window among the positions of chunk k; part[k] is the
// count of the rows before chunk k's first, part[kThreads] of all rows.
// v = -1 where the chunk holds no window position.
__device__ __forceinline__ Best chunk_best(const unsigned short* cnt, const int* part, int k, const Geometry& g) {
  Best best{-1, 0};
  const int positions = g.n_sub - g.w_sub + 1;
  const int a = chunk_start(k, g);
  const int e = chunk_start(k + 1, g) < positions ? chunk_start(k + 1, g) : positions;
  if (a >= e) return best;
  int lo = part[k];  // P(x)
  const int far = a + g.w_sub;
  const int kf = far / g.chunk < kThreads ? far / g.chunk : kThreads;
  int hi = part[kf];  // P(x + w_sub)
  for (int j = chunk_start(kf, g); j < far; ++j) hi += cnt[j];
  for (int x = a; x < e; ++x) {
    const int v = hi - lo;
    if (v > best.v) best = Best{v, x};
    lo += cnt[x];
    if (x + g.w_sub < g.n_sub) hi += cnt[x + g.w_sub];
  }
  return best;
}

// the larger count, then the smaller position
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// tile t's start: the best window's first row, or the static proportional
// start where no sampled row is a member; clamped to [0, N - width]
__device__ __forceinline__ int place(Best best, int total, int t, int tile, int M, int N, int stride,
                                     const Geometry& g) {
  long long st = total > 0
                     ? static_cast<long long>(best.i) * stride
                     : ((2LL * t * tile + tile) * N) / (2LL * M) - g.width / 2;
  const long long hi = N - g.width;
  st = st < 0 ? 0 : (st > hi ? hi : st);
  return static_cast<int>(st);
}

}  // namespace window_starts
