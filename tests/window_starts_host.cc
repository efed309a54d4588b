// A host build of csrc/window_starts.cuh's steps behind the same C entry
// point as csrc/window_starts.cu, so that the block's logic runs on the
// CPU in the tests (tests/test_torch_window_starts.py): each (frame, tile)
// block in turn, its threads' steps one thread after another, the chunk
// sums scanned and the threads' best windows reduced in thread order (the
// kernel's shuffle tree picks the same window: the larger count, then the
// smaller position, is a total order).  The CUDA rounding intrinsics become
// single float operations (no contraction on x86-64 without -mfma); the
// stream argument is ignored.
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }

#include "window_starts.cuh"

using namespace window_starts;

extern "C" int window_starts_launch(const void* q, const void* s, const void* thr_q, float thr, void* starts,
                                    int B, int M, int N, int tile, int stride, int width, void* stream) {
  (void)stream;
  if (B < 1 || B > 65535 || M < 1 || N < 1 || tile < 1 || tile > kMaxTile || M % tile || stride < 1 ||
      width < 1 || geometry(N, stride, width).n_sub > kMaxRows)
    return 1;
  const float* qf = static_cast<const float*>(q);
  const float* sf = static_cast<const float*>(s);
  const float* tq = static_cast<const float*>(thr_q);
  int* out = static_cast<int*>(starts);
  const Geometry g = geometry(N, stride, width);
  const int tiles = M / tile;
  std::vector<Query> qs(tile);
  std::vector<unsigned short> cnt(g.n_sub);
  std::vector<int> part(kThreads + 1);
  for (int b = 0; b < B; ++b) {
    for (int t = 0; t < tiles; ++t) {
      const long q0 = static_cast<long>(b) * M + static_cast<long>(t) * tile;
      const float* qt = qf + q0 * 3;
      const float rx = qt[0], ry = qt[1], rz = qt[2];
      for (int i = 0; i < tile; ++i) qs[i] = centred(qt + 3 * i, rx, ry, rz, tq != nullptr ? tq[q0 + i] : thr);
      const float* sb = sf + static_cast<long>(b) * N * 3;
      for (int j = 0; j < g.n_sub; ++j)
        cnt[j] = static_cast<unsigned short>(
            row_count(qs.data(), tile, sb + static_cast<long>(j) * stride * 3, rx, ry, rz));
      int acc = 0;
      for (int k = 0; k < kThreads; ++k) {
        part[k] = acc;
        acc += chunk_sum(cnt.data(), k, g);
      }
      part[kThreads] = acc;
      Best best = chunk_best(cnt.data(), part.data(), 0, g);
      for (int k = 1; k < kThreads; ++k) best = better(best, chunk_best(cnt.data(), part.data(), k, g));
      out[static_cast<long>(b) * tiles + t] = place(best, acc, t, tile, M, N, stride, g);
    }
  }
  return 0;
}
