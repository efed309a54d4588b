// The arithmetic of EPnP-RANSAC's two kernels (ransac_pnp.cu), apart from
// the kernels themselves: the plain version's formulas (pose/ransac.py,
// pose/epnp.py, ops/small_linalg.py, ops/geometry.py::rodrigues) operation
// for operation in fp32.  Plain C++ with CUDA's rounding intrinsics, so that
// a host compiler builds it too, given those intrinsics (the CPU tests do:
// tests/test_torch_ransac_math.py); the refinement's sums over the points go
// through a policy (Blk) that the kernel and the host each supply.
//
// Rounding: each elementwise step of the plain version is a PyTorch kernel
// of its own and rounds; here each goes through an _rn intrinsic (struct F),
// which the compiler never fuses into a multiply-add.  Where the plain
// version calls a matrix product (cuBLAS), the sum is a chain of FMAs in k
// order; its short sums over a last dimension (torch.sum, vector_norm) take
// the order of PyTorch's reduction kernel (ATen/native/cuda/Reduce.cuh:
// lanes of width last_pow2(n), then a shuffle-down tree), its sums over
// dimension -2 one thread's four accumulators.  Sums over all N
// correspondences cannot follow cuBLAS's or the reduction kernel's block
// order.  Every clamp, epsilon and where of the plain version stays; NaN
// passes a clamp as in torch.clamp, and argmax takes NaN as the largest and
// the first index on ties, so that frames on which the plain version returns
// NaN poses give NaN here too.
#pragma once

#include <math.h>

namespace ransac {

// An fp32 value whose every operation rounds on its own (no contraction).
struct F {
  float v;
  F() = default;
  __host__ __device__ constexpr F(float x) : v(x) {}
};
__device__ __forceinline__ F operator+(F a, F b) { return F(__fadd_rn(a.v, b.v)); }
__device__ __forceinline__ F operator-(F a, F b) { return F(__fsub_rn(a.v, b.v)); }
__device__ __forceinline__ F operator*(F a, F b) { return F(__fmul_rn(a.v, b.v)); }
__device__ __forceinline__ F operator/(F a, F b) { return F(__fdiv_rn(a.v, b.v)); }
__device__ __forceinline__ F operator-(F a) { return F(-a.v); }
__device__ __forceinline__ bool operator<(F a, F b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(F a, F b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(F a, F b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(F a, F b) { return a.v >= b.v; }
__device__ __forceinline__ F fma_(F a, F b, F c) { return F(__fmaf_rn(a.v, b.v, c.v)); }
__device__ __forceinline__ F sqrt_(F a) { return F(__fsqrt_rn(a.v)); }
// torch.clamp: NaN passes through
__device__ __forceinline__ F clamp_min(F x, float lo) { return x.v < lo ? F(lo) : x; }
__device__ __forceinline__ F clamp(F x, float lo, float hi) { return x.v < lo ? F(lo) : (x.v > hi ? F(hi) : x); }
__device__ __forceinline__ F eye(int i, int j) { return F(i == j ? 1.f : 0.f); }

constexpr float kEpsEpnp = 1e-9f;   // pose/epnp.py::_EPS
constexpr float kEpsLinalg = 1e-12f;  // ops/small_linalg.py::_EPS
constexpr float kTwoThirdsPi = static_cast<float>(2.0 * 3.14159265358979323846 / 3.0);
constexpr int kSample = 6;

__host__ __device__ constexpr int last_pow2(int n) { return n >= 2 ? 2 * last_pow2(n / 2) : 1; }

// torch.sum over a short last dimension (Reduce.cuh, the reduced dimension
// the fastest: width last_pow2(n) lanes, lane j adds x[j] and x[j + w] to
// the identity, then a shuffle-down tree)
template <int n>
__device__ __forceinline__ F tsum(const F* x) {
  constexpr int w = last_pow2(n);
  F l[w];
#pragma unroll
  for (int j = 0; j < w; ++j) l[j] = j + w < n ? (F(0.f) + x[j]) + (F(0.f) + x[j + w]) : F(0.f) + x[j];
#pragma unroll
  for (int off = w / 2; off > 0; off /= 2)
#pragma unroll
    for (int j = 0; j < off; ++j) l[j] = l[j] + l[j + off];
  return l[0];
}

// torch.sum over dimension -2 (Reduce.cuh: one thread, four accumulators)
template <int n>
__device__ __forceinline__ F ssum(const F* x, int stride) {
  F v[4] = {F(0.f), F(0.f), F(0.f), F(0.f)};
#pragma unroll
  for (int i = 0; i < n; ++i) v[i % 4] = v[i % 4] + x[i * stride];
  return ((v[0] + v[1]) + v[2]) + v[3];
}

// a matrix product's sum over k: a chain of FMAs in k order
template <int n>
__device__ __forceinline__ F chain(const F* a, int sa, const F* b, int sb) {
  F acc = fma_(a[0], b[0], F(0.f));
#pragma unroll
  for (int k = 1; k < n; ++k) acc = fma_(a[k * sa], b[k * sb], acc);
  return acc;
}

// The order of a short matrix product's sum over k.  cuBLAS picks its
// kernel by the call's shape and batch count, and its kernels sum in
// different orders, so every product site takes its order at run time: the
// order that reproduces cuBLAS on the plain version's own call
// (pose/ransac.py::dot_orders finds it on the card).
enum Order { kChain = 0, kSeq = 1, kTree = 2, kEvenOdd = 3, kSplit = 4 };  // kSplit + s: two chains split at s

// The product sites, each of the plain version's calls that the kernels
// repeat; an Orders holds each one's order at one batch count.
enum Site {
  kBary,   // (points - c0) @ eigvec
  kCam,    // alphas @ cc
  kLtL,    // case 2's Lt @ L
  kLtdw,   // case 2's Lt @ dw2
  kMM,     // rigid alignment's M @ M @ M
  kRay1,   // einsum("ij,ik->jk"), the first half of the Rayleigh quotients
  kRay2,   // einsum("jk,kj->j"), the second half
  kMq,     // einsum("ij,j->i") of the power and adjugate steps
  kQN,     // einsum("i,ij->j"), the first half of lam
  kDot4,   // einsum("j,j->"), the second half
  kRmu,    // R @ mu_s
  kPR6,    // the six sampled points @ R^T
  kCamK6,  // their camera points @ K^T
  kPRN,    // all N points @ R^T (the counting, the refinement)
  kCamKN,  // their camera points @ K^T
  kCov6,   // the six points' covariance
  kMtM6,   // the six points' M^T M
  kMu6,    // the six points' weighted means
  kS6,     // the six points' cross-covariance
  kJJ,     // J_cam @ J_pose
  kRR,     // rodrigues's K @ K, and its rotation @ R
  kSites
};
struct Orders {
  int m[kSites];
};

template <int K>
__device__ __forceinline__ F dotk(const F* a, int sa, const F* b, int sb, int order) {
  if (order == kChain) return chain<K>(a, sa, b, sb);
  F p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = a[k * sa] * b[k * sb];
  if (order == kSeq) {
    F acc = p[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + p[k];
    return acc;
  }
  if (order == kTree) return tsum<K>(p);
  F x = F(0.f), y = F(0.f);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool first = order == kEvenOdd ? k % 2 == 0 : k < order - kSplit;
    if (first)
      x = fma_(a[k * sa], b[k * sb], x);
    else
      y = fma_(a[k * sa], b[k * sb], y);
  }
  return x + y;
}

// torch.sum(v * v, -1)
template <int n>
__device__ __forceinline__ F norm_sq(const F* v) {
  F s[n];
#pragma unroll
  for (int i = 0; i < n; ++i) s[i] = v[i] * v[i];
  return tsum<n>(s);
}

// torch.linalg.vector_norm over the last dimension
template <int n>
__device__ __forceinline__ F vnorm(const F* v) { return sqrt_(norm_sq<n>(v)); }

// torch.argmax: NaN is the largest, the first index on ties
template <int n>
__device__ __forceinline__ int argmax(const F* x) {
  int best = 0;
  F top = x[0];
#pragma unroll
  for (int i = 1; i < n; ++i)
    if (!isnan(top.v) && (isnan(x[i].v) || x[i].v > top.v)) {
      best = i;
      top = x[i];
    }
  return best;
}

// torch.linalg.cross (its kernel's a1 b2 - a2 b1, the first product fused)
__device__ __forceinline__ void cross(const F* a, const F* b, F* out) {
  out[0] = fma_(a[1], b[2], -(a[2] * b[1]));
  out[1] = fma_(a[2], b[0], -(a[0] * b[2]));
  out[2] = fma_(a[0], b[1], -(a[1] * b[0]));
}

// small_linalg.py::_det3x3 on a row-major 3 x 3
__device__ __forceinline__ F det3(const F* M) {
  return (M[0] * (M[4] * M[8] - M[5] * M[7]) - M[1] * (M[3] * M[8] - M[5] * M[6])) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

// small_linalg.py::eigh3x3's eigvec(lam)
__device__ __forceinline__ void eigvec3(const F* A, F lam, F* out) {
  F M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[3 * i + j] = A[3 * i + j] - lam * eye(i, j);
  F c[9], n2[3];
  cross(M, M + 3, c);
  cross(M, M + 6, c + 3);
  cross(M + 3, M + 6, c + 6);
#pragma unroll
  for (int i = 0; i < 3; ++i) n2[i] = norm_sq<3>(c + 3 * i);
  const int best = argmax<3>(n2);
  F v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = best == 0 ? c[k] : (best == 1 ? c[3 + k] : c[6 + k]);
  const F n = sqrt_(clamp_min(norm_sq<3>(v), kEpsLinalg));
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = n > F(1e-6f) ? v[k] / n : F(k == 0 ? 1.f : 0.f);
}

// small_linalg.py::eigh3x3: ascending eigenvalues, eigenvectors as the
// columns of the row-major vecs (Cardano, cross-product eigenvectors)
__device__ __forceinline__ void eigh3x3(const F* Ain, F* vals, F* vecs) {
  F A[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[3 * i + j] = F(0.5f) * (Ain[3 * i + j] + Ain[3 * j + i]);
  const F diag[3] = {A[0], A[4], A[8]};
  const F q = tsum<3>(diag) * F(1.0f / 3.0f);  // a division by a scalar is a product by its reciprocal
  F Aq[9], sq[9], B[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Aq[3 * i + j] = A[3 * i + j] - q * eye(i, j);
#pragma unroll
  for (int k = 0; k < 9; ++k) sq[k] = Aq[k] * Aq[k];
  const F p = sqrt_(clamp_min(tsum<9>(sq) * F(1.0f / 6.0f), kEpsLinalg));
#pragma unroll
  for (int k = 0; k < 9; ++k) B[k] = Aq[k] / p;
  const F r = clamp(det3(B) * F(0.5f), -1.f, 1.f);
  const F phi = F(acosf(r.v)) * F(1.0f / 3.0f);
  const F tp = F(2.0f) * p;
  const F e1 = q + tp * F(cosf(phi.v));
  const F e3 = q + tp * F(cosf((phi + F(kTwoThirdsPi)).v));
  const F e2 = (F(3.0f) * q - e1) - e3;
  vals[0] = e3;
  vals[1] = e2;
  vals[2] = e1;
  F v0[3], v2[3], prod[3];
  eigvec3(A, e3, v0);
  eigvec3(A, e1, v2);
#pragma unroll
  for (int k = 0; k < 3; ++k) prod[k] = v2[k] * v0[k];
  const F d = tsum<3>(prod);
#pragma unroll
  for (int k = 0; k < 3; ++k) v2[k] = v2[k] - d * v0[k];
  const F n2 = sqrt_(clamp_min(norm_sq<3>(v2), kEpsLinalg));
  const F ey[3] = {F(0.f), F(1.f), F(0.f)};
  F alt[3], v1[3];
  cross(v0, ey, alt);
  const F an = sqrt_(clamp_min(norm_sq<3>(alt), kEpsLinalg));
#pragma unroll
  for (int k = 0; k < 3; ++k) v2[k] = n2 > F(1e-6f) ? v2[k] / n2 : alt[k] / an;
  cross(v2, v0, v1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vecs[3 * k + 0] = v0[k];
    vecs[3 * k + 1] = v1[k];
    vecs[3 * k + 2] = v2[k];
  }
}

// small_linalg.py::cholesky_unrolled, reading A's lower triangle (row-major n x n)
template <int n>
__device__ __forceinline__ void cholesky(const F* A, F* L) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    F s = A[j * n + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j * n + k] * L[j * n + k];
    L[j * n + j] = sqrt_(clamp_min(s, kEpsLinalg));
    const F inv = F(1.f) / L[j * n + j];
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      F t = A[i * n + j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i * n + k] * L[j * n + k];
      L[i * n + j] = t * inv;
    }
  }
}

// small_linalg.py::cho_solve_unrolled
template <int n>
__device__ __forceinline__ void cho_solve(const F* L, const F* b, F* x) {
  F y[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    F s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i * n + k] * y[k];
    y[i] = s / L[i * n + i];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    F s = y[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) s = s - L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

// v / sqrt(clamp(|v|^2))
template <int n>
__device__ __forceinline__ void normalize(F* v) {
  const F s = sqrt_(clamp_min(norm_sq<n>(v), kEpsLinalg));
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = v[i] / s;
}

// v - (v . u) u
template <int n>
__device__ __forceinline__ void deflate(F* v, const F* u) {
  F prod[n];
#pragma unroll
  for (int i = 0; i < n; ++i) prod[i] = v[i] * u[i];
  const F d = tsum<n>(prod);
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = v[i] - d * u[i];
}

// small_linalg.py::smallest_eigvecs(A, num=2) on the 12 x 12 normal matrix
// (A's lower triangle): shifted inverse iteration with deflation
__device__ __forceinline__ void smallest_eigvecs12(const F* A, F* v1, F* v2) {
  constexpr int n = 12;
  F diag[n];
#pragma unroll
  for (int i = 0; i < n; ++i) diag[i] = A[i * n + i];
  const F scale = clamp_min(tsum<n>(diag) * F(1.0f / 12.0f), 1.f);
  const F sh = scale * F(1e-4f);
  F As[n * n], L[n * n];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) As[i * n + j] = A[i * n + j] + sh * eye(i, j);
  cholesky<n>(As, L);
#pragma unroll
  for (int i = 0; i < n; ++i) v1[i] = eye(i, 0) + F(0.1f);
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    F x[n];
    cho_solve<n>(L, v1, x);
#pragma unroll
    for (int i = 0; i < n; ++i) v1[i] = x[i];
    normalize<n>(v1);
  }
  normalize<n>(v1);
#pragma unroll
  for (int i = 0; i < n; ++i) v2[i] = eye(i, 1) + F(0.1f);
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    F x[n];
    deflate<n>(v2, v1);
    cho_solve<n>(L, v2, x);
#pragma unroll
    for (int i = 0; i < n; ++i) v2[i] = x[i];
    normalize<n>(v2);
  }
  deflate<n>(v2, v1);
  normalize<n>(v2);
}

// small_linalg.py::solve3x3 (adjugate over the columns of a row-major A)
__device__ __forceinline__ void solve3x3(const F* A, const F* b, F* x) {
  const F col0[3] = {A[0], A[3], A[6]}, col1[3] = {A[1], A[4], A[7]}, col2[3] = {A[2], A[5], A[8]};
  F c[9], prod[3];
  cross(col1, col2, c);
  cross(col2, col0, c + 3);
  cross(col0, col1, c + 6);
#pragma unroll
  for (int k = 0; k < 3; ++k) prod[k] = col0[k] * c[k];
  const F det = tsum<3>(prod);
  const F safe = fabsf(det.v) > kEpsLinalg ? det : (det >= F(0.f) ? F(kEpsLinalg) : F(-kEpsLinalg));
  const F inv = F(1.f) / safe;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) prod[k] = c[3 * i + k] * b[k];
    x[i] = tsum<3>(prod) * inv;
  }
}

// epnp.py::_PAIRS
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  i = p < 3 ? 0 : (p < 5 ? 1 : 2);
  j = p < 3 ? p + 1 : (p < 5 ? p - 1 : 3);
}

// the norms of the six pair differences of four 3-vectors (row-major 4 x 3)
__device__ __forceinline__ void pair_norms(const F* c, F* out) {
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    int i, j;
    pair_of(p, i, j);
    F d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = c[3 * i + k] - c[3 * j + k];
    out[p] = vnorm<3>(d);
  }
}

// sum(dc * dw) / clamp(sum(dc * dc)) * cc: the scale both cases end with
__device__ __forceinline__ void scale_to(const F* cc, const F* dc, const F* dw, F* out) {
  F a[6], b[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    a[p] = dc[p] * dw[p];
    b[p] = dc[p] * dc[p];
  }
  const F s = tsum<6>(a) / clamp_min(tsum<6>(b), kEpsEpnp);
#pragma unroll
  for (int k = 0; k < 12; ++k) out[k] = s * cc[k];
}

// epnp.py::_solve_betas_case1
__device__ __forceinline__ void betas_case1(const F* v, const F* ctrl, F* cc) {
  F dc[6], dw[6];
  pair_norms(v, dc);
  pair_norms(ctrl, dw);
  scale_to(v, dc, dw, cc);
}

// epnp.py::_solve_betas_case2
__device__ __forceinline__ void betas_case2(const F* a, const F* b, const F* ctrl, const Orders& o, F* cc) {
  F dw2[6], L[18];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    int i, j;
    pair_of(p, i, j);
    F da[3], db[3], w[3], t[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      da[k] = a[3 * i + k] - a[3 * j + k];
      db[k] = b[3 * i + k] - b[3 * j + k];
      w[k] = ctrl[3 * i + k] - ctrl[3 * j + k];
      w[k] = w[k] * w[k];  // ** 2
    }
    dw2[p] = tsum<3>(w);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = da[k] * da[k];
    L[3 * p + 0] = tsum<3>(t);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = da[k] * db[k];
    L[3 * p + 1] = F(2.0f) * tsum<3>(t);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = db[k] * db[k];
    L[3 * p + 2] = tsum<3>(t);
  }
  F ltl[9], rhs[3], sol[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) ltl[3 * i + j] = dotk<6>(L + i, 3, L + j, 3, o.m[kLtL]) + F(1e-9f) * eye(i, j);
    rhs[i] = dotk<6>(L + i, 3, dw2, 1, o.m[kLtdw]);
  }
  solve3x3(ltl, rhs, sol);
  const F beta1 = sqrt_(clamp_min(sol[0], kEpsEpnp));
  const F sgn = F(static_cast<float>((0.f < sol[1].v) - (sol[1].v < 0.f)));  // torch.sign
  const F beta2 = sqrt_(clamp_min(sol[2], kEpsEpnp)) * sgn;
  F c[12], dc[6], dw[6];
#pragma unroll
  for (int k = 0; k < 12; ++k) c[k] = beta1 * a[k] + beta2 * b[k];
  pair_norms(c, dc);
#pragma unroll
  for (int p = 0; p < 6; ++p) dw[p] = sqrt_(dw2[p]);
  scale_to(c, dc, dw, cc);
}

// small_linalg.py::_det3 of A (row-major 4 x 4) without row ri and column cj
__device__ __forceinline__ F minor4(const F* A, int ri, int cj) {
  F M[9];
  int r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i == ri) continue;
    int c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j == cj) continue;
      M[3 * r + c] = A[4 * i + j];
      ++c;
    }
    ++r;
  }
  return det3(M);
}

// small_linalg.py::rigid_align_weighted after its sums: Horn's quaternion
// from the weighted cross-covariance S (row-major) and the two weighted means
__device__ __forceinline__ void rigid_from_moments(const F* S, const F* mu_s, const F* mu_d, const Orders& o, F* R,
                                                   F* t) {
  const F sxx = S[0], sxy = S[1], sxz = S[2], syx = S[3], syy = S[4], syz = S[5], szx = S[6], szy = S[7],
          szz = S[8];
  const F N[16] = {
      (sxx + syy) + szz, syz - szy, szx - sxz, sxy - syx,
      syz - szy, (sxx - syy) - szz, sxy + syx, szx + sxz,
      szx - sxz, sxy + syx, (-sxx + syy) - szz, syz + szy,
      sxy - syx, szx + sxz, syz + szy, (-sxx - syy) + szz,
  };
  F nn[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) nn[k] = N[k] * N[k];
  const F fro = sqrt_(clamp_min(tsum<16>(nn), kEpsLinalg));
  F M[16], MM[16], P[16], Pn[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) M[4 * i + j] = N[4 * i + j] + fro * eye(i, j);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) MM[4 * i + j] = dotk<4>(M + 4 * i, 1, M + j, 4, o.m[kMM]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) P[4 * i + j] = dotk<4>(MM + 4 * i, 1, M + j, 4, o.m[kMM]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    F col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) col[i] = P[4 * i + j] * P[4 * i + j];
    const F s = sqrt_(clamp_min(ssum<4>(col, 1), kEpsLinalg));
#pragma unroll
    for (int i = 0; i < 4; ++i) Pn[4 * i + j] = P[4 * i + j] / s;
  }
  // einsum("ij,ik,kj->j"): T[j][k] = sum_i Pn[i][j] N[i][k], then sum_k T[j][k] Pn[k][j]
  F ray[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    F T[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) T[k] = dotk<4>(Pn + j, 4, N + k, 4, o.m[kRay1]);
    ray[j] = dotk<4>(T, 1, Pn + j, 4, o.m[kRay2]);
  }
  const int best = argmax<4>(ray);
  F q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = best == 0 ? Pn[4 * i] : (best == 1 ? Pn[4 * i + 1] : (best == 2 ? Pn[4 * i + 2] : Pn[4 * i + 3]));
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    F qn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qn[i] = dotk<4>(M + 4 * i, 1, q, 1, o.m[kMq]);
    normalize<4>(qn);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qn[i];
  }
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    F T[4], A[16], adj[16], qn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) T[j] = dotk<4>(q, 1, N + j, 4, o.m[kQN]);
    const F lam = dotk<4>(T, 1, q, 1, o.m[kDot4]);
    const F c = lam + F(1e-6f) * fro;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[4 * i + j] = N[4 * i + j] - c * eye(i, j);
    // _adj4: entry [a][b] is the cofactor of (b, a)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) adj[4 * a + b] = F((a + b) % 2 ? -1.f : 1.f) * minor4(A, b, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) qn[i] = dotk<4>(adj + 4 * i, 1, q, 1, o.m[kMq]);
    normalize<4>(qn);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qn[i];
  }
  const F w0 = q[0], x = q[1], y = q[2], z = q[3];
  const F one(1.f), two(2.f);
  R[0] = one - two * (y * y + z * z);
  R[1] = two * (x * y - z * w0);
  R[2] = two * (x * z + y * w0);
  R[3] = two * (x * y + z * w0);
  R[4] = one - two * (x * x + z * z);
  R[5] = two * (y * z - x * w0);
  R[6] = two * (x * z - y * w0);
  R[7] = two * (y * z + x * w0);
  R[8] = one - two * (x * x + y * y);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = mu_d[i] - dotk<3>(R + 3 * i, 1, mu_s, 1, o.m[kRmu]);
}

// epnp.py::reprojection_errors for one point: +inf behind the camera
__device__ __forceinline__ F reproj_err(const F* R, const F* t, const F* p, F u, F v, const F* Km, int pr, int ck) {
  F cam[3], uvw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) cam[i] = dotk<3>(p, 1, R + 3 * i, 1, pr) + t[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) uvw[i] = dotk<3>(cam, 1, Km + 3 * i, 1, ck);
  const F den = clamp_min(uvw[2], kEpsEpnp);
  const F d[2] = {uvw[0] / den - u, uvw[1] / den - v};
  const F err = vnorm<2>(d);
  return cam[2] > F(1e-6f) ? err : F(INFINITY);
}

// The control points' frame: epnp.py::_control_points after its sums.
struct Frame {
  F c0[3], E[9], scale[3], ctrl[12];
};

__device__ __forceinline__ void frame_from_moments(const F* c0, const F* cov, Frame& f) {
  F vals[3];
  eigh3x3(cov, vals, f.E);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.c0[k] = c0[k];
    f.ctrl[k] = c0[k];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) f.scale[j] = sqrt_(clamp_min(vals[j], 1e-8f));
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) f.ctrl[3 * (j + 1) + k] = c0[k] + f.E[3 * k + j] * f.scale[j];
}

// epnp.py::_barycentric for one point
__device__ __forceinline__ void barycentric(const Frame& f, const F* p, int order, F* alpha) {
  F d[3], a[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = p[k] - f.c0[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) a[j] = dotk<3>(d, 1, f.E + j, 3, order) / clamp_min(f.scale[j], 1e-8f);
  alpha[0] = F(1.f) - tsum<3>(a);
#pragma unroll
  for (int j = 0; j < 3; ++j) alpha[j + 1] = a[j];
}

// one point's two rows of epnp's M, weighted by sqrt(w)
__device__ __forceinline__ void m_rows(const F* alpha, F u, F v, F w, const F* Km, F* r1, F* r2) {
  const F fx = Km[0], fy = Km[4], cx = Km[2], cy = Km[5];
  const F cu = cx - u, cv = cy - v, sw = sqrt_(w);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    r1[3 * c + 0] = (alpha[c] * fx) * sw;
    r1[3 * c + 1] = F(0.f) * sw;
    r1[3 * c + 2] = (alpha[c] * cu) * sw;
    r2[3 * c + 0] = F(0.f) * sw;
    r2[3 * c + 1] = (alpha[c] * fy) * sw;
    r2[3 * c + 2] = (alpha[c] * cv) * sw;
  }
}

// alphas @ cc for one point
__device__ __forceinline__ void cam_point(const F* alpha, const F* cc, int order, F* cam) {
#pragma unroll
  for (int k = 0; k < 3; ++k) cam[k] = dotk<4>(alpha, 1, cc + k, 3, order);
}

// ------------------------------------------------------------ six points
// The hypothesis stage's EPnP on the six sampled points with unit weights:
// its sums over the points in the plain version's order for n = 6.
struct Six {
  F p[kSample][3], u[kSample], v[kSample];
};

__device__ __forceinline__ void pose_from_cc_six(const Six& s, const Frame& f, const F* cc, const F* Km,
                                                 const Orders& o, F* R, F* t, F& mean_err) {
  const F w(1.f);
  F cam[kSample][3], x[kSample];
#pragma unroll
  for (int i = 0; i < kSample; ++i) {
    F alpha[4];
    barycentric(f, s.p[i], o.m[kBary], alpha);
    cam_point(alpha, cc, o.m[kCam], cam[i]);
    x[i] = w * cam[i][2];
  }
  const F sign = tsum<kSample>(x) < F(0.f) ? F(-1.f) : F(1.f);
#pragma unroll
  for (int i = 0; i < kSample; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) cam[i][k] = cam[i][k] * sign;
  // rigid_align_weighted(object points, cam, w)
  F ones[kSample], wn[kSample];
#pragma unroll
  for (int i = 0; i < kSample; ++i) ones[i] = w;
  const F wsum = clamp_min(tsum<kSample>(ones), kEpsLinalg);
#pragma unroll
  for (int i = 0; i < kSample; ++i) wn[i] = w / wsum;
  F mu_s[3], mu_d[3], S[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mu_s[k] = dotk<kSample>(wn, 1, &s.p[0][k], 3, o.m[kMu6]);
    mu_d[k] = dotk<kSample>(wn, 1, &cam[0][k], 3, o.m[kMu6]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    F l[kSample], r[kSample];
#pragma unroll
    for (int i = 0; i < kSample; ++i) l[i] = wn[i] * (s.p[i][a] - mu_s[a]);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int i = 0; i < kSample; ++i) r[i] = cam[i][b] - mu_d[b];
      S[3 * a + b] = dotk<kSample>(l, 1, r, 1, o.m[kS6]);
    }
  }
  rigid_from_moments(S, mu_s, mu_d, o, R, t);
  F e[kSample];
#pragma unroll
  for (int i = 0; i < kSample; ++i) {
    const F err = reproj_err(R, t, s.p[i], s.u[i], s.v[i], Km, o.m[kPR6], o.m[kCamK6]);
    e[i] = w * (isfinite(err.v) ? err : F(1e6f));
  }
  mean_err = tsum<kSample>(e) / clamp_min(tsum<kSample>(ones), kEpsEpnp);
}

__device__ __forceinline__ void epnp_six(const Six& s, const F* Km, const Orders& o, F* R, F* t) {
  const F w(1.f);
  F ones[kSample], wn[kSample];
#pragma unroll
  for (int i = 0; i < kSample; ++i) ones[i] = w;
  const F wsum = clamp_min(tsum<kSample>(ones), kEpsEpnp);
#pragma unroll
  for (int i = 0; i < kSample; ++i) wn[i] = w / wsum;
  F c0[3], cov[9], cen[kSample][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    F x[kSample];
#pragma unroll
    for (int i = 0; i < kSample; ++i) x[i] = wn[i] * s.p[i][k];
    c0[k] = ssum<kSample>(x, 1);
  }
#pragma unroll
  for (int i = 0; i < kSample; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) cen[i][k] = s.p[i][k] - c0[k];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    F l[kSample];
#pragma unroll
    for (int i = 0; i < kSample; ++i) l[i] = wn[i] * cen[i][a];
#pragma unroll
    for (int b = 0; b < 3; ++b) cov[3 * a + b] = dotk<kSample>(l, 1, &cen[0][b], 3, o.m[kCov6]);
  }
  Frame f;
  frame_from_moments(c0, cov, f);
  // M = [r1 of the six points; r2 of the six points], then M^T M's lower triangle
  F Mr[2 * kSample][12], A[144];
#pragma unroll
  for (int i = 0; i < kSample; ++i) {
    F alpha[4];
    barycentric(f, s.p[i], o.m[kBary], alpha);
    m_rows(alpha, s.u[i], s.v[i], w, Km, Mr[i], Mr[kSample + i]);
  }
#pragma unroll
  for (int a = 0; a < 12; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) A[12 * a + b] = dotk<2 * kSample>(&Mr[0][a], 12, &Mr[0][b], 12, o.m[kMtM6]);
  F v1[12], v2[12], cc1[12], cc2[12];
  smallest_eigvecs12(A, v1, v2);
  betas_case1(v1, f.ctrl, cc1);
  betas_case2(v1, v2, f.ctrl, o, cc2);
  F R1[9], t1[3], R2[9], t2[3], e1, e2;
  pose_from_cc_six(s, f, cc1, Km, o, R1, t1, e1);
  pose_from_cc_six(s, f, cc2, Km, o, R2, t2, e2);
  const bool pick1 = e1 <= e2;
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pick1 ? R1[k] : R2[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pick1 ? t1[k] : t2[k];
}

__device__ __forceinline__ void load_point(const float* obj, const float* img, long n, F* p, F& u, F& v) {
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = F(obj[3 * n + k]);
  u = F(img[2 * n]);
  v = F(img[2 * n + 1]);
}

// geometry.py::rodrigues(d) @ R
__device__ __forceinline__ void rodrigues_update(const F* d, int order, F* R) {
  const F th = vnorm<3>(d);
  const F den = clamp_min(th, kEpsLinalg);
  const F kx = d[0] / den, ky = d[1] / den, kz = d[2] / den;
  const F z(0.f);
  const F Kx[9] = {z, -kz, ky, kz, z, -kx, -ky, kx, z};
  F KK[9], Rr[9], Rn[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) KK[3 * i + j] = dotk<3>(Kx + 3 * i, 1, Kx + j, 3, order);
  const F s = F(sinf(th.v)), c1 = F(1.f) - F(cosf(th.v));
  const bool rot = th > F(kEpsLinalg);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rr[3 * i + j] = rot ? (eye(i, j) + s * Kx[3 * i + j]) + c1 * KK[3 * i + j] : eye(i, j);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rn[3 * i + j] = dotk<3>(Rr + 3 * i, 1, R + j, 3, order);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rn[k];
}

// ------------------------------------------------------------ refinement
// ransac.py::ransac_pnp_plain after the hypotheses, in phases around its
// sums over the N points.  Those sums stay the plain version's own PyTorch
// calls (cuBLAS and PyTorch's reduction kernel, whose order over N no
// kernel can repeat at every batch count), on the very tensors the phases
// write; everything else is here.  A phase runs per frame: per-frame work
// in every thread alike, per-point work over Blk's walk (blk.first(),
// blk.step()); blk.count sums an int, blk.sum a float, over the frame;
// blk.sync() orders the frame's threads; blk.frames() is B.
struct Bufs {
  const float* P;    // (B, N, 3) object points
  const float* uv;   // (B, N, 2) image points
  const float* K;    // (B, 3, 3)
  const float* m;    // (B, N) mask
  const float* hypR;  // (B, H, 9)
  const float* hypt;  // (B, H, 3)
  const int* counts;  // (B, H)
  float* pose;   // (B, 12) the current R (9) and t (3)
  float* w;      // (B, N) this round's weights
  float* wn;     // (B, N) w / clamp(sum w, 1e-9), EPnP's control points
  float* wn2;    // (B, N) w / clamp(sum w, 1e-12), the rigid alignment's
  float* wsum;   // (B,) sum w (exact: 0/1 weights)
  float* prodc0;  // (B, N, 3) wn * P; torch.sum over N -> c0 (B, 3)
  const float* c0;
  float* cen;    // (B, N, 3) P - c0; einsum(wn, cen, cen) -> cov (B, 3, 3)
  const float* cov;
  float* frame;  // (B, 27) c0, eigvec, scale, ctrl
  float* M;      // (B, 2N, 12) M's rows; M^T M -> MtM (B, 12, 12)
  const float* MtM;
  // each of the two cases in tensors of its own, as the plain version has them
  float* cam[2];   // (B, N, 3) alphas @ cc
  float* z[2];     // (B, N) w * cam_z; sum over N -> s (B,)
  const float* s[2];
  const float* mus;  // (B, 3) einsum(wn2, P)
  const float* mc[2];  // (B, 3) einsum(wn2, cam): mu_d before the sign
  float* srcc;     // (B, N, 3) P - mus
  float* dc[2];    // (B, N, 3) cam - mc; einsum(wn2, srcc, dc) -> Sc (B, 3, 3)
  const float* Sc[2];
  float* cand;     // (2, B, 12) the two cases' poses
  float* ew[2];    // (B, N) w * err (1e6 where not finite); sum over N -> e (B,)
  const float* e[2];
  // the Gauss-Newton terms; Jw and J also in the layouts einsum("nik,nil->kl")
  // permutes them to, (k, i, n) and ((i, n), l), so that its views of them in
  // the plain version's shapes need no copy (the same bits at every batch
  // count; einsum("nik,ni->k") gives them only from Jw as the plain version
  // lays it out, at B = 1)
  float* Jw;     // (B, 6, 2, N) J * w
  float* J;      // (B, 2, N, 6)
  float* JwP;    // (B, N, 2, 6) J * w
  float* r;      // (B, 2, N) residuals; einsum(Jw, J) -> Hs (B, 6, 6), einsum(JwP, r) -> g (B, 6)
  const float* Hs;
  const float* g;
  float* R_out;  // (B, 3, 3)
  float* t_out;  // (B, 3)
  unsigned char* inl_out;  // (B, N)
  int* num_out;  // (B,)
  unsigned char* succ_out;  // (B,)
  int H, N;
  float thr;
};

__device__ __forceinline__ void load_pose(const float* p, F* R, F* t) {
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = F(p[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = F(p[9 + k]);
}

__device__ __forceinline__ void load_frame(const float* p, Frame& f) {
#pragma unroll
  for (int k = 0; k < 3; ++k) f.c0[k] = F(p[k]);
#pragma unroll
  for (int k = 0; k < 9; ++k) f.E[k] = F(p[3 + k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) f.scale[k] = F(p[12 + k]);
#pragma unroll
  for (int k = 0; k < 12; ++k) f.ctrl[k] = F(p[15 + k]);
}

__device__ __forceinline__ void load_k(const Bufs& q, long b, F* Km) {
#pragma unroll
  for (int k = 0; k < 9; ++k) Km[k] = F(q.K[b * 9 + k]);
}

// torch.argmax over the counts (the first index on ties): the pose to refine
__device__ __forceinline__ void phase_best(const Bufs& q, long b) {
  int best = 0, top = q.counts[b * q.H];
  for (int h = 1; h < q.H; ++h)
    if (q.counts[b * q.H + h] > top) {
      top = q.counts[b * q.H + h];
      best = h;
    }
#pragma unroll
  for (int k = 0; k < 9; ++k) q.pose[b * 12 + k] = q.hypR[(b * q.H + best) * 9 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) q.pose[b * 12 + 9 + k] = q.hypt[(b * q.H + best) * 3 + k];
}

// the inliers of this frame's pose: weights (the mask where fewer than 4)
// and what EPnP's first sum takes
template <class Blk>
__device__ __forceinline__ void phase_weights(const Bufs& q, const Orders& o, Blk& blk, long b) {
  F R[9], t[3], Km[9];
  load_pose(q.pose + b * 12, R, t);
  load_k(q, b, Km);
  const long base = b * q.N;
  int c = 0;
  F ms = F(0.f);
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    F p[3], u, v;
    load_point(q.P, q.uv, base + n, p, u, v);
    const bool in = reproj_err(R, t, p, u, v, Km, o.m[kPRN], o.m[kCamKN]).v < q.thr && q.m[base + n] > 0.f;
    q.w[base + n] = in ? 1.f : 0.f;
    c += in;
    ms = ms + F(q.m[base + n]);
  }
  c = blk.count(c);
  ms = blk.sum(ms);
  const bool use_inl = c >= 4;
  // sums of 0/1 weights are exact in any order
  const F ws = use_inl ? F(static_cast<float>(c)) : ms;
  const F ws1 = clamp_min(ws, kEpsEpnp), ws2 = clamp_min(ws, kEpsLinalg);
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    const F w = use_inl ? F(q.w[base + n]) : F(q.m[base + n]);
    const F wn = w / ws1;
    q.w[base + n] = w.v;
    q.wn[base + n] = wn.v;
    q.wn2[base + n] = (w / ws2).v;
#pragma unroll
    for (int k = 0; k < 3; ++k) q.prodc0[(base + n) * 3 + k] = (wn * F(q.P[(base + n) * 3 + k])).v;
  }
  if (blk.first() == 0) q.wsum[b] = ws.v;
}

template <class Blk>
__device__ __forceinline__ void phase_centre(const Bufs& q, Blk& blk, long b) {
  const long base = b * q.N;
  for (int n = blk.first(); n < q.N; n += blk.step())
#pragma unroll
    for (int k = 0; k < 3; ++k) q.cen[(base + n) * 3 + k] = (F(q.P[(base + n) * 3 + k]) - F(q.c0[b * 3 + k])).v;
}

// the control points' frame from the covariance, and M's rows
template <class Blk>
__device__ __forceinline__ void phase_frame(const Bufs& q, const Orders& o, Blk& blk, long b) {
  F c0[3], cov[9], Km[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) c0[k] = F(q.c0[b * 3 + k]);
#pragma unroll
  for (int k = 0; k < 9; ++k) cov[k] = F(q.cov[b * 9 + k]);
  load_k(q, b, Km);
  Frame f;
  frame_from_moments(c0, cov, f);
  if (blk.first() == 0) {
    float* fr = q.frame + b * 27;
#pragma unroll
    for (int k = 0; k < 3; ++k) fr[k] = f.c0[k].v;
#pragma unroll
    for (int k = 0; k < 9; ++k) fr[3 + k] = f.E[k].v;
#pragma unroll
    for (int k = 0; k < 3; ++k) fr[12 + k] = f.scale[k].v;
#pragma unroll
    for (int k = 0; k < 12; ++k) fr[15 + k] = f.ctrl[k].v;
  }
  const long base = b * q.N;
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    F p[3], u, v, alpha[4], r1[12], r2[12];
    load_point(q.P, q.uv, base + n, p, u, v);
    barycentric(f, p, o.m[kBary], alpha);
    m_rows(alpha, u, v, F(q.w[base + n]), Km, r1, r2);
    float* row1 = q.M + (b * 2 * q.N + n) * 12;
    float* row2 = q.M + (b * 2 * q.N + q.N + n) * 12;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      row1[k] = r1[k].v;
      row2[k] = r2[k].v;
    }
  }
}

// the two smallest eigenvectors, both cases' control points in the camera,
// and each point in the camera under each case
template <class Blk>
__device__ __forceinline__ void phase_eig(const Bufs& q, const Orders& o, Blk& blk, long b) {
  F A[144];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) A[12 * i + j] = F(q.MtM[b * 144 + 12 * i + j]);
  Frame f;
  load_frame(q.frame + b * 27, f);
  F v1[12], v2[12], cc[2][12];
  smallest_eigvecs12(A, v1, v2);
  betas_case1(v1, f.ctrl, cc[0]);
  betas_case2(v1, v2, f.ctrl, o, cc[1]);
  const long base = b * q.N;
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    F p[3], u, v, alpha[4];
    load_point(q.P, q.uv, base + n, p, u, v);
    barycentric(f, p, o.m[kBary], alpha);
    const F w = F(q.w[base + n]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      F cam[3];
      cam_point(alpha, cc[c], o.m[kCam], cam);
#pragma unroll
      for (int k = 0; k < 3; ++k) q.cam[c][(base + n) * 3 + k] = cam[k].v;
      q.z[c][base + n] = (w * cam[2]).v;
    }
  }
}

template <class Blk>
__device__ __forceinline__ void phase_moments(const Bufs& q, Blk& blk, long b) {
  const long base = b * q.N;
  for (int n = blk.first(); n < q.N; n += blk.step())
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long i = (base + n) * 3 + k;
      q.srcc[i] = (F(q.P[i]) - F(q.mus[b * 3 + k])).v;
#pragma unroll
      for (int c = 0; c < 2; ++c) q.dc[c][i] = (F(q.cam[c][i]) - F(q.mc[c][b * 3 + k])).v;
    }
}

// each case's rigid alignment (the sign applied after the sums: negating
// every camera point negates mu_d and S exactly), and its weighted errors
template <class Blk>
__device__ __forceinline__ void phase_rigid(const Bufs& q, const Orders& o, Blk& blk, long b) {
  const long B = blk.frames();
  F Km[9], mus[3], Rc[2][9], tc[2][3];
  load_k(q, b, Km);
#pragma unroll
  for (int k = 0; k < 3; ++k) mus[k] = F(q.mus[b * 3 + k]);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const F sign = F(q.s[c][b]) < F(0.f) ? F(-1.f) : F(1.f);
    F S[9], mud[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = F(q.Sc[c][b * 9 + k]) * sign;
#pragma unroll
    for (int k = 0; k < 3; ++k) mud[k] = F(q.mc[c][b * 3 + k]) * sign;
    rigid_from_moments(S, mus, mud, o, Rc[c], tc[c]);
    if (blk.first() == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) q.cand[(c * B + b) * 12 + k] = Rc[c][k].v;
#pragma unroll
      for (int k = 0; k < 3; ++k) q.cand[(c * B + b) * 12 + 9 + k] = tc[c][k].v;
    }
  }
  const long base = b * q.N;
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    F p[3], u, v;
    load_point(q.P, q.uv, base + n, p, u, v);
    const F w = F(q.w[base + n]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const F err = reproj_err(Rc[c], tc[c], p, u, v, Km, o.m[kPRN], o.m[kCamKN]);
      q.ew[c][base + n] = (w * (isfinite(err.v) ? err : F(1e6f))).v;
    }
  }
}

// epnp.py::refine_pose_gauss_newton's per-point terms under the current pose
template <class Blk>
__device__ __forceinline__ void gauss_newton_terms(const Bufs& q, const Orders& o, Blk& blk, long b) {
  F R[9], t[3], Km[9];
  load_pose(q.pose + b * 12, R, t);
  load_k(q, b, Km);
  const F fx = Km[0], fy = Km[4], cx = Km[2], cy = Km[5];
  const long base = b * q.N;
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    F p[3], u, v, cam[3];
    load_point(q.P, q.uv, base + n, p, u, v);
    const F w = F(q.w[base + n]);
#pragma unroll
    for (int i = 0; i < 3; ++i) cam[i] = dotk<3>(p, 1, R + 3 * i, 1, o.m[kPRN]) + t[i];
    const F x = cam[0], y = cam[1], zc = clamp_min(cam[2], 1e-6f);
    const F z2 = zc * zc, zero(0.f);
    q.r[(b * 2 + 0) * q.N + n] = (((fx * x) / zc + cx) - u).v;
    q.r[(b * 2 + 1) * q.N + n] = (((fy * y) / zc + cy) - v).v;
    const F Jc[6] = {fx / zc, zero, ((-fx) * x) / z2, zero, fy / zc, ((-fy) * y) / z2};
    // [-skew(cam) | I3], with the unclamped cam
    const F Jp[18] = {-zero, cam[2], -cam[1], F(1.f), zero, zero,
                      -cam[2], -zero, cam[0], zero, F(1.f), zero,
                      cam[1], -cam[0], -zero, zero, zero, F(1.f)};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const F j = dotk<3>(Jc + 3 * i, 1, Jp + c, 6, o.m[kJJ]);
        const F jw = j * w;
        q.J[((b * 2 + i) * q.N + n) * 6 + c] = j.v;
        q.Jw[((b * 6 + c) * 2 + i) * q.N + n] = jw.v;
        q.JwP[((base + n) * 2 + i) * 6 + c] = jw.v;
      }
  }
}

// the case with the lower mean error, then the first Gauss-Newton terms
template <class Blk>
__device__ __forceinline__ void phase_pick(const Bufs& q, const Orders& o, Blk& blk, long b) {
  const long B = blk.frames();
  const F ws = clamp_min(F(q.wsum[b]), kEpsEpnp);
  const F e1 = F(q.e[0][b]) / ws, e2 = F(q.e[1][b]) / ws;
  const int c = e1 <= e2 ? 0 : 1;
  blk.sync();
  if (blk.first() == 0)
#pragma unroll
    for (int k = 0; k < 12; ++k) q.pose[b * 12 + k] = q.cand[(c * B + b) * 12 + k];
  blk.sync();
  gauss_newton_terms(q, o, blk, b);
}

// one Gauss-Newton step from the summed system, then (more) the next terms
template <class Blk>
__device__ __forceinline__ void phase_gauss_newton(const Bufs& q, const Orders& o, Blk& blk, long b, int more) {
  F R[9], t[3], Hm[36], L[36], sol[6], gv[6], d[3];
  load_pose(q.pose + b * 12, R, t);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    gv[i] = F(q.g[b * 6 + i]);
#pragma unroll
    for (int j = 0; j <= i; ++j) Hm[6 * i + j] = F(q.Hs[b * 36 + 6 * i + j]) + F(1e-6f) * eye(i, j);
  }
  cholesky<6>(Hm, L);
  cho_solve<6>(L, gv, sol);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = -sol[i];
  rodrigues_update(d, o.m[kRR], R);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t[i] + (-sol[3 + i]);
  blk.sync();
  if (blk.first() == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) q.pose[b * 12 + k] = R[k].v;
#pragma unroll
    for (int k = 0; k < 3; ++k) q.pose[b * 12 + 9 + k] = t[k].v;
  }
  blk.sync();
  if (more) gauss_newton_terms(q, o, blk, b);
}

// the final inliers, their count and the outputs
template <class Blk>
__device__ __forceinline__ void phase_final(const Bufs& q, const Orders& o, Blk& blk, long b) {
  F R[9], t[3], Km[9];
  load_pose(q.pose + b * 12, R, t);
  load_k(q, b, Km);
  const long base = b * q.N;
  int c = 0;
  for (int n = blk.first(); n < q.N; n += blk.step()) {
    F p[3], u, v;
    load_point(q.P, q.uv, base + n, p, u, v);
    const bool in = reproj_err(R, t, p, u, v, Km, o.m[kPRN], o.m[kCamKN]).v < q.thr && q.m[base + n] > 0.f;
    q.inl_out[base + n] = in;
    c += in;
  }
  c = blk.count(c);
  if (blk.first() == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) q.R_out[b * 9 + k] = R[k].v;
#pragma unroll
    for (int k = 0; k < 3; ++k) q.t_out[b * 3 + k] = t[k].v;
    q.num_out[b] = c;
    q.succ_out[b] = c >= 4;
  }
}

// the order of ransac_refine_launch's pointer array (pose/ransac.py::_BUFS)
enum Ptr {
  pP, pUV, pK, pM, pHypR, pHypT, pCounts, pPose, pW, pWn, pWn2, pWsum, pProdc0, pC0, pCen, pCov, pFrame, pMrows,
  pMtM, pCam1, pCam2, pZ1, pZ2, pS1, pS2, pMus, pMc1, pMc2, pSrcc, pDc1, pDc2, pSc1, pSc2, pCand, pEw1, pEw2, pE1,
  pE2, pJw, pJ, pJwP, pR, pHs, pG, pRout, pTout, pInl, pNum, pSucc, kPtrs
};

inline Bufs unpack(const long long* ptrs, int H, int N, float thr) {
  Bufs q;
  auto f = [&](int i) { return reinterpret_cast<float*>(ptrs[i]); };
  q.P = f(pP); q.uv = f(pUV); q.K = f(pK); q.m = f(pM); q.hypR = f(pHypR); q.hypt = f(pHypT);
  q.counts = reinterpret_cast<const int*>(ptrs[pCounts]);
  q.pose = f(pPose); q.w = f(pW); q.wn = f(pWn); q.wn2 = f(pWn2); q.wsum = f(pWsum); q.prodc0 = f(pProdc0);
  q.c0 = f(pC0); q.cen = f(pCen); q.cov = f(pCov); q.frame = f(pFrame); q.M = f(pMrows); q.MtM = f(pMtM);
  for (int c = 0; c < 2; ++c) {
    q.cam[c] = f(pCam1 + c); q.z[c] = f(pZ1 + c); q.s[c] = f(pS1 + c); q.mc[c] = f(pMc1 + c);
    q.dc[c] = f(pDc1 + c); q.Sc[c] = f(pSc1 + c); q.ew[c] = f(pEw1 + c); q.e[c] = f(pE1 + c);
  }
  q.mus = f(pMus); q.srcc = f(pSrcc); q.cand = f(pCand); q.Jw = f(pJw); q.J = f(pJ); q.JwP = f(pJwP);
  q.r = f(pR);
  q.Hs = f(pHs); q.g = f(pG); q.R_out = f(pRout); q.t_out = f(pTout);
  q.inl_out = reinterpret_cast<unsigned char*>(ptrs[pInl]);
  q.num_out = reinterpret_cast<int*>(ptrs[pNum]);
  q.succ_out = reinterpret_cast<unsigned char*>(ptrs[pSucc]);
  q.H = H;
  q.N = N;
  q.thr = thr;
  return q;
}

inline Orders read_orders(const int* orders) {
  Orders o;
  for (int i = 0; i < kSites; ++i) o.m[i] = orders[i];
  return o;
}

// the refinement's phases (pose/ransac.py: BEST, WEIGHTS, ...)
enum Phase { kBest, kWeights, kCentre, kFrame, kEig, kMoments, kRigid, kPick, kGaussNewton, kFinal };

}  // namespace ransac
