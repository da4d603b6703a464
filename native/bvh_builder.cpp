// Native cluster-BVH builder (SURVEY.md §2 row 5 — the reference's
// KD-tree builder is native C++; this is its cluster-BVH equivalent).
//
// Builds a binned-SAH BVH over triangle centroids and flattens it into
// fixed-size leaf clusters (<= leaf_size triangles each), emitting the
// cluster-major triangle permutation + per-cluster AABBs that the
// JAX/Pallas traversal kernels consume (tputracer/accel/bvh.py).
//
// SAH (16 bins per axis, surface-area cost) picks split planes that
// minimize expected intersection work, which directly reduces the number
// of clusters a ray tile visits at trace time; the NumPy fallback uses
// median splits.  Splits that would strand fewer than count/8 triangles
// on one side fall back to the median so leaf sizes stay near leaf_size
// (padding waste is bounded).
//
// C ABI (ctypes): see tpt_build_clusters at the bottom.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  V3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void grow(const AABB &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
  float axis_lo(int a) const { return a == 0 ? lo.x : (a == 1 ? lo.y : lo.z); }
  float axis_hi(int a) const { return a == 0 ? hi.x : (a == 1 ? hi.y : hi.z); }
};

struct Builder {
  const float *tv;  // (T, 3, 3) row-major vertices
  int leaf_size;
  std::vector<V3> cent;
  std::vector<AABB> tri_box;
  std::vector<int> order;                 // permutation being partitioned
  std::vector<std::vector<int>> leaves;   // cluster -> tri indices

  V3 centroid(int t) const { return cent[t]; }

  void build(int lo, int hi) {
    int n = hi - lo;
    if (n <= leaf_size) {
      leaves.emplace_back(order.begin() + lo, order.begin() + hi);
      return;
    }
    // centroid bounds
    AABB cb;
    for (int i = lo; i < hi; ++i) cb.grow(cent[order[i]]);

    // binned SAH over the widest viable axis set
    constexpr int NB = 16;
    int best_axis = -1, best_bin = -1;
    float best_cost = FLT_MAX;
    for (int axis = 0; axis < 3; ++axis) {
      float c0 = cb.axis_lo(axis), c1 = cb.axis_hi(axis);
      if (c1 - c0 < 1e-12f) continue;
      float inv = NB / (c1 - c0);
      AABB bins[NB];
      int cnt[NB] = {0};
      for (int i = lo; i < hi; ++i) {
        int t = order[i];
        float c = axis == 0 ? cent[t].x : (axis == 1 ? cent[t].y : cent[t].z);
        int b = std::min(NB - 1, std::max(0, (int)((c - c0) * inv)));
        bins[b].grow(tri_box[t]);
        cnt[b]++;
      }
      // sweep: cost(k) = SA_left*n_left + SA_right*n_right
      AABB acc;
      float la[NB];
      int lc[NB];
      int c = 0;
      for (int b = 0; b < NB; ++b) {
        if (cnt[b]) acc.grow(bins[b]);
        c += cnt[b];
        la[b] = c ? acc.half_area() : 0.f;
        lc[b] = c;
      }
      acc = AABB();
      c = 0;
      for (int b = NB - 1; b >= 1; --b) {
        if (cnt[b]) acc.grow(bins[b]);
        c += cnt[b];
        int nl = lc[b - 1], nr = c;
        if (nl == 0 || nr == 0) continue;
        // keep splits balanced enough that leaf padding stays bounded
        if (nl < n / 8 || nr < n / 8) continue;
        float cost = la[b - 1] * nl + acc.half_area() * nr;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    int mid;
    if (best_axis >= 0) {
      float c0 = cb.axis_lo(best_axis), c1 = cb.axis_hi(best_axis);
      float split = c0 + (c1 - c0) * best_bin / 16.0f;
      auto it = std::partition(
          order.begin() + lo, order.begin() + hi, [&](int t) {
            float c = best_axis == 0
                          ? cent[t].x
                          : (best_axis == 1 ? cent[t].y : cent[t].z);
            return c < split;
          });
      mid = (int)(it - order.begin());
      if (mid == lo || mid == hi) best_axis = -1;  // degenerate: median
    }
    if (best_axis < 0) {
      // median split on the widest centroid axis
      int axis = 0;
      float ex = cb.hi.x - cb.lo.x, ey = cb.hi.y - cb.lo.y,
            ez = cb.hi.z - cb.lo.z;
      if (ey > ex && ey >= ez) axis = 1;
      else if (ez > ex && ez > ey) axis = 2;
      mid = lo + n / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid,
                       order.begin() + hi, [&](int a, int b) {
                         float ca = axis == 0 ? cent[a].x
                                              : (axis == 1 ? cent[a].y
                                                           : cent[a].z);
                         float cb_ = axis == 0 ? cent[b].x
                                               : (axis == 1 ? cent[b].y
                                                            : cent[b].z);
                         return ca < cb_;
                       });
    }
    build(lo, mid);
    build(mid, hi);
  }
};

}  // namespace

extern "C" {

// Returns the number of clusters written, or -1 if max_clusters was too
// small.  Outputs:
//   perm  (max_clusters * leaf_size) int32  — source tri per padded slot
//   mask  (max_clusters * leaf_size) float  — 1 real / 0 padding
//   cmin/cmax (max_clusters * 3) float      — cluster AABBs (eps-padded)
int tpt_build_clusters(const float *tv, int n_tris, int leaf_size,
                       float eps, int32_t *perm, float *mask, float *cmin,
                       float *cmax, int max_clusters) {
  Builder b;
  b.tv = tv;
  b.leaf_size = leaf_size;
  b.cent.resize(n_tris);
  b.tri_box.resize(n_tris);
  for (int t = 0; t < n_tris; ++t) {
    const float *p = tv + 9 * t;
    AABB box;
    for (int v = 0; v < 3; ++v) {
      V3 q{p[3 * v], p[3 * v + 1], p[3 * v + 2]};
      box.grow(q);
    }
    b.tri_box[t] = box;
    b.cent[t] = {(box.lo.x + box.hi.x) * 0.5f, (box.lo.y + box.hi.y) * 0.5f,
                 (box.lo.z + box.hi.z) * 0.5f};
  }
  b.order.resize(n_tris);
  for (int t = 0; t < n_tris; ++t) b.order[t] = t;
  if (n_tris > 0) b.build(0, n_tris);

  int C = (int)b.leaves.size();
  if (C > max_clusters) return -1;
  std::memset(perm, 0, sizeof(int32_t) * (size_t)max_clusters * leaf_size);
  std::memset(mask, 0, sizeof(float) * (size_t)max_clusters * leaf_size);
  for (int i = 0; i < max_clusters * 3; ++i) {
    cmin[i] = 3.0e38f;  // padding clusters: degenerate far box (bvh.py)
    cmax[i] = 3.0e38f;
  }
  for (int c = 0; c < C; ++c) {
    AABB box;
    float m = 0.f;
    for (size_t k = 0; k < b.leaves[c].size(); ++k) {
      int t = b.leaves[c][k];
      perm[(size_t)c * leaf_size + k] = t;
      mask[(size_t)c * leaf_size + k] = 1.0f;
      box.grow(b.tri_box[t]);
      m = std::max(m, std::max(std::fabs(box.lo.x),
                               std::max(std::fabs(box.hi.x),
                                        std::max(std::fabs(box.hi.y),
                                                 std::fabs(box.hi.z)))));
    }
    float ext = eps * std::max(1.0f, m);
    cmin[3 * c] = box.lo.x - ext;
    cmin[3 * c + 1] = box.lo.y - ext;
    cmin[3 * c + 2] = box.lo.z - ext;
    cmax[3 * c] = box.hi.x + ext;
    cmax[3 * c + 1] = box.hi.y + ext;
    cmax[3 * c + 2] = box.hi.z + ext;
  }
  return C;
}
}
