// Native host-side data-pipeline ops of the PyTorch port: a copy of the
// JAX package's host ops, so the port builds them from its own tree.
//
// The reference delegates its host-side heavy lifting to external C++
// (Open3D voxel_down_sample + KDTreeFlann, reference data/kitti.py:148-180,
// 240-254).  This library provides the same capabilities natively so the
// loader's hot path doesn't run through NumPy:
//   - voxel-grid downsample with per-voxel attribute averaging
//   - exact kNN via a 3-D uniform-grid index
//   - farthest point sampling
//
// Exposed through a plain C ABI consumed via ctypes
// (cofii2p_tpu_torch/native/__init__.py, which builds it with g++ on first
// use).  The voxel order (first occurrence) decides which points a frame's
// fixed-size resample draws, so the code and the flags stay the JAX
// package's.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelKey {
  int32_t x, y, z;
  bool operator==(const VoxelKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct VoxelKeyHash {
  size_t operator()(const VoxelKey& k) const {
    // 3-D -> 64-bit mix (large odd constants, xor-fold)
    uint64_t h = static_cast<uint32_t>(k.x) * 0x9E3779B185EBCA87ULL;
    h ^= static_cast<uint32_t>(k.y) * 0xC2B2AE3D27D4EB4FULL;
    h ^= static_cast<uint32_t>(k.z) * 0x165667B19E3779F9ULL;
    return static_cast<size_t>(h ^ (h >> 29));
  }
};

}  // namespace

extern "C" {

// Voxel-grid downsample with attribute averaging.
// points: n x 3, attrs: n x a (may be null when a == 0).
// out_points: capacity x 3, out_attrs: capacity x a.
// Returns the number of voxels written (<= capacity; surplus voxels are
// dropped in hash order, matching the fixed-capacity device op).
int64_t voxel_downsample(const float* points, const float* attrs, int64_t n,
                         int64_t a, float voxel_size, float* out_points,
                         float* out_attrs, int64_t capacity) {
  std::unordered_map<VoxelKey, int64_t, VoxelKeyHash> slots;
  slots.reserve(static_cast<size_t>(n));
  std::vector<double> psum;
  std::vector<double> asum;
  std::vector<int64_t> counts;
  const float inv = 1.0f / voxel_size;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + 3 * i;
    VoxelKey key{static_cast<int32_t>(std::floor(p[0] * inv)),
                 static_cast<int32_t>(std::floor(p[1] * inv)),
                 static_cast<int32_t>(std::floor(p[2] * inv))};
    auto it = slots.find(key);
    int64_t slot;
    if (it == slots.end()) {
      slot = static_cast<int64_t>(counts.size());
      slots.emplace(key, slot);
      psum.resize(psum.size() + 3, 0.0);
      if (a) asum.resize(asum.size() + a, 0.0);
      counts.push_back(0);
    } else {
      slot = it->second;
    }
    counts[slot] += 1;
    for (int d = 0; d < 3; ++d) psum[3 * slot + d] += p[d];
    for (int64_t d = 0; d < a; ++d) asum[a * slot + d] += attrs[a * i + d];
  }
  const int64_t m = std::min<int64_t>(static_cast<int64_t>(counts.size()), capacity);
  for (int64_t s = 0; s < m; ++s) {
    const double c = static_cast<double>(counts[s]);
    for (int d = 0; d < 3; ++d)
      out_points[3 * s + d] = static_cast<float>(psum[3 * s + d] / c);
    for (int64_t d = 0; d < a; ++d)
      out_attrs[a * s + d] = static_cast<float>(asum[a * s + d] / c);
  }
  return m;
}

namespace {

// Uniform-grid spatial index for exact kNN on LiDAR-scale clouds.
struct GridIndex {
  float cell;
  float origin[3];
  int32_t dims[3];
  std::vector<int32_t> starts;   // per-cell start into point_ids
  std::vector<int32_t> point_ids;

  int64_t cell_of(const float* p, int32_t* cxyz) const {
    for (int d = 0; d < 3; ++d) {
      int32_t c = static_cast<int32_t>(std::floor((p[d] - origin[d]) / cell));
      cxyz[d] = std::min(std::max(c, 0), dims[d] - 1);
    }
    return (static_cast<int64_t>(cxyz[2]) * dims[1] + cxyz[1]) * dims[0] + cxyz[0];
  }
};

GridIndex build_grid(const float* db, int64_t m, float cell) {
  GridIndex g;
  g.cell = cell;
  float hi[3];
  for (int d = 0; d < 3; ++d) {
    g.origin[d] = db[d];
    hi[d] = db[d];
  }
  for (int64_t i = 1; i < m; ++i)
    for (int d = 0; d < 3; ++d) {
      g.origin[d] = std::min(g.origin[d], db[3 * i + d]);
      hi[d] = std::max(hi[d], db[3 * i + d]);
    }
  int64_t ncells = 1;
  for (int d = 0; d < 3; ++d) {
    g.dims[d] = std::max<int32_t>(
        1, static_cast<int32_t>((hi[d] - g.origin[d]) / cell) + 1);
    ncells *= g.dims[d];
    // cap the grid so degenerate extents don't blow memory
    if (ncells > (1 << 24)) {
      g.dims[d] = std::max<int32_t>(1, g.dims[d] / 2);
      ncells = static_cast<int64_t>(g.dims[0]) * g.dims[1] * g.dims[2];
    }
  }
  std::vector<int32_t> counts(static_cast<size_t>(ncells) + 1, 0);
  std::vector<int64_t> cell_of(m);
  int32_t cxyz[3];
  for (int64_t i = 0; i < m; ++i) {
    cell_of[i] = g.cell_of(db + 3 * i, cxyz);
    counts[cell_of[i] + 1]++;
  }
  for (size_t c = 1; c < counts.size(); ++c) counts[c] += counts[c - 1];
  g.starts = counts;
  g.point_ids.resize(m);
  std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < m; ++i) g.point_ids[cursor[cell_of[i]]++] = static_cast<int32_t>(i);
  return g;
}

}  // namespace

// Exact kNN: for each of n queries find the k nearest of m database points.
// out_idx: n x k int32 (padded with m when fewer than k points exist).
// grid_cell <= 0 picks a heuristic cell size from the db density.
void knn_search(const float* queries, int64_t n, const float* db, int64_t m,
                int64_t k, float grid_cell, int32_t* out_idx) {
  if (m == 0) {
    std::fill(out_idx, out_idx + n * k, 0);
    return;
  }
  float cell = grid_cell;
  if (cell <= 0.0f) {
    // heuristic: aim for ~2 points per cell
    float lo[3] = {db[0], db[1], db[2]}, hi[3] = {db[0], db[1], db[2]};
    for (int64_t i = 1; i < m; ++i)
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], db[3 * i + d]);
        hi[d] = std::max(hi[d], db[3 * i + d]);
      }
    double vol = 1.0;
    for (int d = 0; d < 3; ++d) vol *= std::max(1e-3f, hi[d] - lo[d]);
    cell = static_cast<float>(std::cbrt(vol * 2.0 / static_cast<double>(m)));
  }
  GridIndex g = build_grid(db, m, cell);

  std::vector<std::pair<float, int32_t>> heap;  // max-heap of (dist2, id)
  for (int64_t qi = 0; qi < n; ++qi) {
    const float* q = queries + 3 * qi;
    heap.clear();
    int32_t cq[3];
    g.cell_of(q, cq);
    // expand rings of cells until the k-th best distance beats the ring bound
    for (int32_t ring = 0;; ++ring) {
      bool any_cell = false;
      for (int32_t dz = -ring; dz <= ring; ++dz) {
        for (int32_t dy = -ring; dy <= ring; ++dy) {
          for (int32_t dx = -ring; dx <= ring; ++dx) {
            if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != ring)
              continue;  // shell only
            const int32_t cx = cq[0] + dx, cy = cq[1] + dy, cz = cq[2] + dz;
            if (cx < 0 || cy < 0 || cz < 0 || cx >= g.dims[0] ||
                cy >= g.dims[1] || cz >= g.dims[2])
              continue;
            any_cell = true;
            const int64_t c =
                (static_cast<int64_t>(cz) * g.dims[1] + cy) * g.dims[0] + cx;
            for (int32_t s = g.starts[c]; s < g.starts[c + 1]; ++s) {
              const int32_t id = g.point_ids[s];
              const float* p = db + 3 * id;
              const float d2 = (q[0] - p[0]) * (q[0] - p[0]) +
                               (q[1] - p[1]) * (q[1] - p[1]) +
                               (q[2] - p[2]) * (q[2] - p[2]);
              if (heap.size() < static_cast<size_t>(k)) {
                heap.emplace_back(d2, id);
                std::push_heap(heap.begin(), heap.end());
              } else if (d2 < heap.front().first) {
                std::pop_heap(heap.begin(), heap.end());
                heap.back() = {d2, id};
                std::push_heap(heap.begin(), heap.end());
              }
            }
          }
        }
      }
      // stop when the worst kept distance is inside the guaranteed-covered
      // radius (ring * cell), or the grid is exhausted
      const float covered = static_cast<float>(ring) * g.cell;
      if (heap.size() == static_cast<size_t>(k) &&
          heap.front().first <= covered * covered)
        break;
      const int32_t max_dim = std::max({g.dims[0], g.dims[1], g.dims[2]});
      if (!any_cell && ring > max_dim) break;
    }
    std::sort_heap(heap.begin(), heap.end());
    int64_t written = 0;
    for (; written < static_cast<int64_t>(heap.size()) && written < k; ++written)
      out_idx[qi * k + written] = heap[written].second;
    for (; written < k; ++written) out_idx[qi * k + written] = static_cast<int32_t>(m);
  }
}

// Greedy farthest point sampling; start_idx seeds the first pick.
void farthest_point_sampling(const float* points, int64_t n, int64_t k,
                             int64_t start_idx, int32_t* out_idx) {
  std::vector<float> best(n, 1e30f);
  int64_t cur = start_idx;
  for (int64_t i = 0; i < k; ++i) {
    out_idx[i] = static_cast<int32_t>(cur);
    const float* c = points + 3 * cur;
    int64_t nxt = 0;
    float far = -1.0f;
    for (int64_t j = 0; j < n; ++j) {
      const float* p = points + 3 * j;
      const float d2 = (c[0] - p[0]) * (c[0] - p[0]) +
                       (c[1] - p[1]) * (c[1] - p[1]) +
                       (c[2] - p[2]) * (c[2] - p[2]);
      best[j] = std::min(best[j], d2);
      if (best[j] > far) {
        far = best[j];
        nxt = j;
      }
    }
    cur = nxt;
  }
}

}  // extern "C"
