// A host build of csrc/ransac_pnp.cuh's arithmetic behind the same two C
// entry points as csrc/ransac_pnp.cu, one frame and one hypothesis at a
// time, so that pose/ransac.py::run_kernels runs on the CPU in the tests
// (tests/test_torch_ransac_host.py).  The CUDA rounding intrinsics become
// single float operations (no contraction on x86-64 without -mfma); the
// stream argument is ignored.
#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
static inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
using std::isfinite;
using std::isnan;

#include "ransac_pnp.cuh"

using namespace ransac;

namespace {

// every point of a frame in one thread
struct Serial {
  int B;
  int first() const { return 0; }
  int step() const { return 1; }
  int frames() const { return B; }
  void sync() const {}
  int count(int c) const { return c; }
  F sum(F v) const { return v; }
};

// torch.sort's descending order (NaN first, -0 ties +0, masked rows -inf)
unsigned order_key(float x) {
  if (std::isnan(x)) return 0xffffffffu;
  if (x == 0.f) x = 0.f;
  unsigned u;
  std::memcpy(&u, &x, 4);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

}  // namespace

extern "C" int ransac_hyp_launch(const void* gumbel, const void* obj, const void* img, const void* K,
                                 const void* mask, int B, int H, int N, int sample_size, float thr,
                                 const int* orders, void* samples, void* hypR, void* hypt, void* counts,
                                 void* stream) {
  if (sample_size != kSample || N < kSample || B < 1 || H < 1) return 1;
  const Orders o = read_orders(orders);
  const float* g = static_cast<const float*>(gumbel);
  const float* P = static_cast<const float*>(obj);
  const float* uv = static_cast<const float*>(img);
  const float* m = static_cast<const float*>(mask);
  const unsigned neg_inf = order_key(-INFINITY);
  std::vector<int> idx(N);
  for (long b = 0; b < B; ++b) {
    F Km[9];
    for (int k = 0; k < 9; ++k) Km[k] = F(static_cast<const float*>(K)[b * 9 + k]);
    for (long h = 0; h < H; ++h) {
      const long gh = b * H + h;
      for (int n = 0; n < N; ++n) idx[n] = n;
      auto key = [&](int n) { return m[b * N + n] > 0.f ? order_key(g[gh * N + n]) : neg_inf; };
      std::stable_sort(idx.begin(), idx.end(), [&](int x, int y) { return key(x) > key(y); });
      Six s;
      for (int r = 0; r < kSample; ++r) {
        static_cast<int*>(samples)[gh * kSample + r] = idx[r];
        load_point(P + b * N * 3, uv + b * N * 2, idx[r], s.p[r], s.u[r], s.v[r]);
      }
      F R[9], t[3];
      epnp_six(s, Km, o, R, t);
      int c = 0;
      for (int n = 0; n < N; ++n) {
        F p[3], u, v;
        load_point(P + b * N * 3, uv + b * N * 2, n, p, u, v);
        c += reproj_err(R, t, p, u, v, Km, o.m[kPRN], o.m[kCamKN]).v < thr && m[b * N + n] > 0.f;
      }
      static_cast<int*>(counts)[gh] = c;
      for (int k = 0; k < 9; ++k) static_cast<float*>(hypR)[gh * 9 + k] = R[k].v;
      for (int k = 0; k < 3; ++k) static_cast<float*>(hypt)[gh * 3 + k] = t[k].v;
    }
  }
  return 0;
}

extern "C" int ransac_refine_launch(int phase, const long long* ptrs, const int* orders, int B, int H, int N,
                                    float thr, int more, void* stream) {
  const Bufs q = unpack(ptrs, H, N, thr);
  const Orders o = read_orders(orders);
  Serial blk{B};
  for (long b = 0; b < B; ++b) {
    switch (phase) {
      case kBest: phase_best(q, b); break;
      case kWeights: phase_weights(q, o, blk, b); break;
      case kCentre: phase_centre(q, blk, b); break;
      case kFrame: phase_frame(q, o, blk, b); break;
      case kEig: phase_eig(q, o, blk, b); break;
      case kMoments: phase_moments(q, blk, b); break;
      case kRigid: phase_rigid(q, o, blk, b); break;
      case kPick: phase_pick(q, o, blk, b); break;
      case kGaussNewton: phase_gauss_newton(q, o, blk, b, more); break;
      case kFinal: phase_final(q, o, blk, b); break;
      default: return 1;
    }
  }
  return 0;
}
