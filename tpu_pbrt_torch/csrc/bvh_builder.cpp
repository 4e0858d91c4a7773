// Native binned-SAH BVH builder.
//
// Capability match for pbrt-v3 src/accelerators/bvh.cpp
// BVHAccel::recursiveBuild (12-bucket binned SAH, pbrt's leaf/split cost
// model, depth-first LinearBVHNode layout with the left child adjacent and
// the far child patched by offset) — the native-runtime counterpart of
// tpu_pbrt/accel/build.py::_build_recursive, which it matches node for
// node (same f64 internal math, same bucket assignment, same cost
// formula, same stable tie-breaking) so the Python fallback and this
// builder are interchangeable.
//
// Why native: scene compilation is host runtime, exactly the layer the
// reference implements in C++. The Python SAH loop visits every node in
// interpreter code (~25 s for a 128k-triangle scene); this builder is a
// tight memcpy-free loop over caller-allocated output arrays, ~50-100x
// faster, which is what makes crown-class (3.5M tris) SAH builds
// practical instead of falling back to the lower-quality Morton build.
//
// Build: g++ -O3 -shared -fPIC -o libbvh.so bvh_builder.cpp
// ABI: plain C, caller allocates (see build_sah_bvh).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBuckets = 12;
constexpr double kTraversalCost = 0.125;  // pbrt: 1/8 node vs intersect

struct V3 {
  double x, y, z;
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double area(const V3 &mn, const V3 &mx) {
  double dx = std::max(mx.x - mn.x, 0.0);
  double dy = std::max(mx.y - mn.y, 0.0);
  double dz = std::max(mx.z - mn.z, 0.0);
  return 2.0 * (dx * dy + dx * dz + dy * dz);
}
inline double axis_of(const V3 &v, int dim) {
  return dim == 0 ? v.x : (dim == 1 ? v.y : v.z);
}

struct Builder {
  const double *bmin, *bmax;  // (n, 3) f64
  int64_t n;
  int max_leaf;

  float *out_min, *out_max;           // (cap, 3)
  int32_t *out_prim_off, *out_nprims; // (cap,)
  int32_t *out_second, *out_axis;     // (cap,)
  int64_t *out_order;                 // (n,)

  std::vector<V3> cen;
  std::vector<int64_t> idx;   // working permutation
  std::vector<int64_t> scratch;
  int64_t slot = 0;
  int64_t n_order = 0;

  V3 get(const double *arr, int64_t i) const {
    return {arr[3 * i], arr[3 * i + 1], arr[3 * i + 2]};
  }

  void emit_bounds(int64_t s, const V3 &mn, const V3 &mx) {
    out_min[3 * s] = (float)mn.x;
    out_min[3 * s + 1] = (float)mn.y;
    out_min[3 * s + 2] = (float)mn.z;
    out_max[3 * s] = (float)mx.x;
    out_max[3 * s + 1] = (float)mx.y;
    out_max[3 * s + 2] = (float)mx.z;
  }

  void make_leaf(int64_t my_slot, int64_t lo, int64_t hi) {
    out_prim_off[my_slot] = (int32_t)n_order;
    out_nprims[my_slot] = (int32_t)(hi - lo);
    for (int64_t i = lo; i < hi; ++i) out_order[n_order++] = idx[i];
  }

  struct Task {
    int64_t lo, hi, patch_parent;  // patch_parent < 0: no far-child patch
  };
  std::vector<Task> tasks;

  // builds the whole tree iteratively (explicit stack — unbalanced SAH
  // splits on multi-million-primitive scenes would overflow the C stack);
  // pushing right-then-left reproduces the recursive DFS layout: the left
  // child lands at parent+1, the right child's slot patches out_second.
  void build_all(int64_t lo0, int64_t hi0) {
    tasks.push_back({lo0, hi0, -1});
    while (!tasks.empty()) {
      Task t = tasks.back();
      tasks.pop_back();
      if (t.patch_parent >= 0) out_second[t.patch_parent] = (int32_t)slot;
      build_node(t.lo, t.hi);
    }
  }

  // emits ONE node for [lo, hi) and pushes child tasks
  void build_node(int64_t lo, int64_t hi) {
    int64_t my_slot = slot++;
    V3 nb_min = get(bmin, idx[lo]);
    V3 nb_max = get(bmax, idx[lo]);
    for (int64_t i = lo + 1; i < hi; ++i) {
      nb_min = vmin(nb_min, get(bmin, idx[i]));
      nb_max = vmax(nb_max, get(bmax, idx[i]));
    }
    emit_bounds(my_slot, nb_min, nb_max);
    int64_t count = hi - lo;
    if (count == 1) {
      make_leaf(my_slot, lo, hi);
      return;
    }
    V3 cb_min = cen[idx[lo]], cb_max = cen[idx[lo]];
    for (int64_t i = lo + 1; i < hi; ++i) {
      cb_min = vmin(cb_min, cen[idx[i]]);
      cb_max = vmax(cb_max, cen[idx[i]]);
    }
    double ext[3] = {cb_max.x - cb_min.x, cb_max.y - cb_min.y,
                     cb_max.z - cb_min.z};
    int dim = 0;
    if (ext[1] > ext[dim]) dim = 1;
    if (ext[2] > ext[dim]) dim = 2;

    auto split_at = [&](int64_t mid) {
      out_axis[my_slot] = dim;
      out_nprims[my_slot] = 0;
      tasks.push_back({lo + mid, hi, my_slot});  // right (far), patched
      tasks.push_back({lo, lo + mid, -1});       // left: next slot
    };

    if (ext[dim] <= 0.0) {
      if (count <= max_leaf) {
        make_leaf(my_slot, lo, hi);
      } else {
        split_at(count / 2);  // degenerate cluster: forced equal split
      }
      return;
    }
    if (count <= 2) {
      // tiny node: equal-count by centroid (argpartition equivalent)
      std::sort(idx.begin() + lo, idx.begin() + hi,
                [&](int64_t a, int64_t b) {
                  return axis_of(cen[a], dim) < axis_of(cen[b], dim);
                });
      split_at(count / 2);
      return;
    }

    // 12-bucket binned SAH (bvh.cpp "Allocate BucketInfo...")
    int64_t counts[kBuckets] = {0};
    V3 bk_min[kBuckets], bk_max[kBuckets];
    for (int b = 0; b < kBuckets; ++b) {
      bk_min[b] = {std::numeric_limits<double>::infinity(),
                   std::numeric_limits<double>::infinity(),
                   std::numeric_limits<double>::infinity()};
      bk_max[b] = {-std::numeric_limits<double>::infinity(),
                   -std::numeric_limits<double>::infinity(),
                   -std::numeric_limits<double>::infinity()};
    }
    auto bucket_of = [&](int64_t prim) {
      double t = (axis_of(cen[prim], dim) - axis_of(cb_min, dim)) / ext[dim];
      int b = (int)(kBuckets * t);
      return std::min(b, kBuckets - 1);
    };
    for (int64_t i = lo; i < hi; ++i) {
      int b = bucket_of(idx[i]);
      counts[b]++;
      bk_min[b] = vmin(bk_min[b], get(bmin, idx[i]));
      bk_max[b] = vmax(bk_max[b], get(bmax, idx[i]));
    }
    // prefix/suffix sweeps
    double cost[kBuckets - 1];
    int64_t cnt_f[kBuckets], cnt_b[kBuckets];
    V3 mn_f[kBuckets], mx_f[kBuckets], mn_b[kBuckets], mx_b[kBuckets];
    cnt_f[0] = counts[0];
    mn_f[0] = bk_min[0];
    mx_f[0] = bk_max[0];
    for (int b = 1; b < kBuckets; ++b) {
      cnt_f[b] = cnt_f[b - 1] + counts[b];
      mn_f[b] = vmin(mn_f[b - 1], bk_min[b]);
      mx_f[b] = vmax(mx_f[b - 1], bk_max[b]);
    }
    cnt_b[kBuckets - 1] = counts[kBuckets - 1];
    mn_b[kBuckets - 1] = bk_min[kBuckets - 1];
    mx_b[kBuckets - 1] = bk_max[kBuckets - 1];
    for (int b = kBuckets - 2; b >= 0; --b) {
      cnt_b[b] = cnt_b[b + 1] + counts[b];
      mn_b[b] = vmin(mn_b[b + 1], bk_min[b]);
      mx_b[b] = vmax(mx_b[b + 1], bk_max[b]);
    }
    double total_area = std::max(area(nb_min, nb_max), 1e-30);
    int best = -1;
    bool any_valid = false;
    double best_cost = std::numeric_limits<double>::infinity();
    for (int b = 0; b < kBuckets - 1; ++b) {
      bool valid = cnt_f[b] > 0 && cnt_b[b + 1] > 0;
      if (!valid) {
        cost[b] = std::numeric_limits<double>::infinity();
        continue;
      }
      any_valid = true;
      cost[b] = kTraversalCost + (cnt_f[b] * area(mn_f[b], mx_f[b]) +
                                  cnt_b[b + 1] * area(mn_b[b + 1], mx_b[b + 1])) /
                                     total_area;
      if (cost[b] < best_cost) {
        best_cost = cost[b];
        best = b;
      }
    }
    double leaf_cost = (double)count;
    if (count > max_leaf || best_cost < leaf_cost) {
      if (!any_valid) {
        std::sort(idx.begin() + lo, idx.begin() + hi,
                  [&](int64_t a, int64_t b) {
                    return axis_of(cen[a], dim) < axis_of(cen[b], dim);
                  });
        split_at(count / 2);
        return;
      }
      // stable partition: bucket <= best first, original order preserved
      // (matches numpy argsort(~left, kind='stable'))
      int64_t mid = 0;
      scratch.clear();
      int64_t w = lo;
      for (int64_t i = lo; i < hi; ++i) {
        if (bucket_of(idx[i]) <= best) {
          idx[w++] = idx[i];
          mid++;
        } else {
          scratch.push_back(idx[i]);
        }
      }
      std::memcpy(idx.data() + w, scratch.data(),
                  scratch.size() * sizeof(int64_t));
      split_at(mid);
    } else {
      make_leaf(my_slot, lo, hi);
    }
  }
};

}  // namespace

extern "C" {

// Returns the node count; -1 on error. Caller allocates out arrays at
// capacity 2n+1 (nodes) / n (order). Inputs are (n,3) float64 AABBs.
int64_t build_sah_bvh(const double *bmin, const double *bmax, int64_t n,
                      int32_t max_leaf, float *out_min, float *out_max,
                      int32_t *out_prim_off, int32_t *out_nprims,
                      int32_t *out_second, int32_t *out_axis,
                      int64_t *out_order) {
  if (n <= 0 || max_leaf <= 0) return -1;
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.n = n;
  b.max_leaf = max_leaf;
  b.out_min = out_min;
  b.out_max = out_max;
  b.out_prim_off = out_prim_off;
  b.out_nprims = out_nprims;
  b.out_second = out_second;
  b.out_axis = out_axis;
  b.out_order = out_order;
  b.cen.resize(n);
  b.idx.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    b.cen[i] = {0.5 * (bmin[3 * i] + bmax[3 * i]),
                0.5 * (bmin[3 * i + 1] + bmax[3 * i + 1]),
                0.5 * (bmin[3 * i + 2] + bmax[3 * i + 2])};
    b.idx[i] = i;
  }
  b.scratch.reserve(n);
  b.build_all(0, n);
  return b.slot;
}
}
