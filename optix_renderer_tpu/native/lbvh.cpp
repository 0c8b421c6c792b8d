// Native LBVH builder — the C++ fast path behind ops/bvh.py.
//
// Replaces the reference's TBB-parallel binned-SAH build (src/utils/bvh.cpp:
// 36-120) with the LBVH scheme the Python reference
// implementation (ops/bvh.py build_lbvh_numpy) defines: 30-bit Morton sort of
// centroid codes, fixed-size leaves, DFS-preorder median-split tree with
// escape links. Bit-identical output to the numpy path (same layout contract)
// — tests/test_native_lbvh.py verifies equivalence.
//
// Built on demand by native/__init__.py via g++ (-O3 -fopenmp); the sort is
// the only O(n log n) stage and uses gnu parallel mode when OpenMP is
// available (the TBB-task-parallelism analog, SURVEY §2.8 item 5).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define SORT __gnu_parallel::sort
#else
#define SORT std::sort
#endif

namespace {

inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

inline uint32_t morton3d(float x, float y, float z) {
  auto q = [](float f) {
    float c = f * 1024.0f;
    if (c < 0.0f) c = 0.0f;
    if (c > 1023.0f) c = 1023.0f;
    return (uint32_t)c;
  };
  return (expand_bits(q(x)) << 2) | (expand_bits(q(y)) << 1) | expand_bits(q(z));
}

struct Range {
  int64_t idx, lo, hi;  // preorder slot, leaf range [lo, hi)
};

}  // namespace

extern "C" {

// All outputs preallocated by the caller:
//   node_min/node_max: [2*n_leaves-1, 3]; skip/first: [2*n_leaves-1];
//   prim: [n_leaves*leaf_size] (int32, -1 padded).
// Returns 0 on success.
int lbvh_build(const float* v0, const float* v1, const float* v2, int64_t n,
               int64_t leaf_size, float* node_min, float* node_max,
               int32_t* skip, int32_t* first, int32_t* prim) {
  if (n <= 0 || leaf_size <= 0) return 1;
  const int64_t n_leaves = (n + leaf_size - 1) / leaf_size;
  const int64_t n_nodes = 2 * n_leaves - 1;

  std::vector<float> tmin(n * 3), tmax(n * 3), cent(n * 3);
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      float a = v0[i * 3 + k], b = v1[i * 3 + k], c = v2[i * 3 + k];
      float mn = std::min(a, std::min(b, c));
      float mx = std::max(a, std::max(b, c));
      tmin[i * 3 + k] = mn;
      tmax[i * 3 + k] = mx;
      cent[i * 3 + k] = 0.5f * (mn + mx);
    }
  }
  for (int64_t i = 0; i < n; ++i)  // centroid bounds (serial: trivial)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], cent[i * 3 + k]);
      hi[k] = std::max(hi[k], cent[i * 3 + k]);
    }
  float ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-12f);

  // (code, original index) pairs; stable sort matches np.argsort(kind=stable)
  std::vector<std::pair<uint32_t, int32_t>> keyed(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    keyed[i] = {morton3d((cent[i * 3 + 0] - lo[0]) / ext[0],
                         (cent[i * 3 + 1] - lo[1]) / ext[1],
                         (cent[i * 3 + 2] - lo[2]) / ext[2]),
                (int32_t)i};
  }
  SORT(keyed.begin(), keyed.end());  // pair compare = stable on (code, index)

  std::memset(prim, 0xFF, sizeof(int32_t) * n_leaves * leaf_size);  // -1 fill
  for (int64_t i = 0; i < n; ++i) prim[i] = keyed[i].second;

  // per-leaf AABBs
  std::vector<float> leaf_min(n_leaves * 3, INFINITY);
  std::vector<float> leaf_max(n_leaves * 3, -INFINITY);
#pragma omp parallel for schedule(static)
  for (int64_t l = 0; l < n_leaves; ++l) {
    const int64_t start = l * leaf_size;
    const int64_t end = std::min(start + leaf_size, n);
    for (int64_t i = start; i < end; ++i) {
      const int64_t t = keyed[i].second;
      for (int k = 0; k < 3; ++k) {
        leaf_min[l * 3 + k] = std::min(leaf_min[l * 3 + k], tmin[t * 3 + k]);
        leaf_max[l * 3 + k] = std::max(leaf_max[l * 3 + k], tmax[t * 3 + k]);
      }
    }
  }

  // DFS-preorder median-split over leaf ranges (explicit stack; the subtree
  // over k leaves always has 2k-1 nodes → child slots are closed-form)
  std::fill(first, first + n_nodes, -1);
  skip[0] = (int32_t)n_nodes;
  std::vector<Range> stack;
  stack.push_back({0, 0, n_leaves});
  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    if (r.hi - r.lo == 1) {  // leaf node
      first[r.idx] = (int32_t)(r.lo * leaf_size);
      for (int k = 0; k < 3; ++k) {
        node_min[r.idx * 3 + k] = leaf_min[r.lo * 3 + k];
        node_max[r.idx * 3 + k] = leaf_max[r.lo * 3 + k];
      }
      continue;
    }
    const int64_t mid = (r.lo + r.hi) / 2;
    const int64_t li = r.idx + 1;
    const int64_t ri = r.idx + 2 * (mid - r.lo);
    skip[li] = (int32_t)ri;
    skip[ri] = skip[r.idx];
    stack.push_back({ri, mid, r.hi});
    stack.push_back({li, r.lo, mid});
  }

  // interior AABBs: preorder children always have HIGHER indices than their
  // parent, so one reverse sweep folds children into parents
  for (int64_t i = n_nodes - 1; i >= 0; --i) {
    if (first[i] >= 0) continue;  // leaf: already boxed
    const int64_t li = i + 1;
    // right child = the escape link of the left child (by construction)
    const int64_t ri = skip[li];
    for (int k = 0; k < 3; ++k) {
      node_min[i * 3 + k] = std::min(node_min[li * 3 + k], node_min[ri * 3 + k]);
      node_max[i * 3 + k] = std::max(node_max[li * 3 + k], node_max[ri * 3 + k]);
    }
  }
  return 0;
}

}  // extern "C"
