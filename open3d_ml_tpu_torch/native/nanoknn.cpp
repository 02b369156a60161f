// Host KD-tree over 3D points: k-nearest and fixed-radius neighbour search.
//
// The port's own copy of the KD-tree of open3d_ml_tpu/native/nanoknn.cpp,
// the same code, so that both packages return the same neighbours in the
// same order (KPConv's radius pyramid keeps the first ``cap`` neighbours of
// each query in the order the tree visits them). The grid subsampling of
// that file is not copied: both packages subsample with numpy.
//
// Built at first use by open3d_ml_tpu_torch/native/__init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC -fopenmp nanoknn.cpp -o <lib>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct KDTree {
  // Flat left-balanced KD-tree over 3D points.
  std::vector<float> pts;     // [n*3], reordered
  std::vector<int32_t> idx;   // reordered -> original index
  int64_t n = 0;

  void build(const float* points, int64_t count) {
    n = count;
    pts.resize(n * 3);
    idx.resize(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
    std::memcpy(pts.data(), points, sizeof(float) * n * 3);
    build_rec(0, n, 0);
  }

  void build_rec(int64_t lo, int64_t hi, int depth) {
    if (hi - lo <= 1) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    // nth_element over interleaved points: sort indices into a scratch,
    // simplest is an index-based partial sort then re-gather.
    std::vector<int64_t> order(hi - lo);
    for (int64_t i = 0; i < hi - lo; ++i) order[i] = lo + i;
    std::nth_element(order.begin(), order.begin() + (mid - lo), order.end(),
                     [&](int64_t a, int64_t b) {
                       return pts[a * 3 + axis] < pts[b * 3 + axis];
                     });
    // apply permutation to pts+idx within [lo, hi)
    std::vector<float> tmp_p((hi - lo) * 3);
    std::vector<int32_t> tmp_i(hi - lo);
    for (int64_t i = 0; i < hi - lo; ++i) {
      std::memcpy(&tmp_p[i * 3], &pts[order[i] * 3], sizeof(float) * 3);
      tmp_i[i] = idx[order[i]];
    }
    std::memcpy(&pts[lo * 3], tmp_p.data(), sizeof(float) * tmp_p.size());
    std::memcpy(&idx[lo], tmp_i.data(), sizeof(int32_t) * tmp_i.size());
    build_rec(lo, mid, depth + 1);
    build_rec(mid + 1, hi, depth + 1);
  }

  inline float dist2(const float* a, const float* b) const {
    float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    return dx * dx + dy * dy + dz * dz;
  }

  void knn(const float* q, int k, int32_t* out_idx, float* out_d2) const {
    // max-heap of (d2, idx)
    std::priority_queue<std::pair<float, int32_t>> heap;
    knn_rec(q, k, 0, n, 0, heap);
    int cnt = (int)heap.size();
    for (int i = cnt - 1; i >= 0; --i) {
      out_d2[i] = heap.top().first;
      out_idx[i] = heap.top().second;
      heap.pop();
    }
    // pad by repeating nearest
    for (int i = cnt; i < k; ++i) {
      out_d2[i] = cnt ? out_d2[cnt - 1] : 0.f;
      out_idx[i] = cnt ? out_idx[0] : 0;
    }
  }

  void knn_rec(const float* q, int k, int64_t lo, int64_t hi, int depth,
               std::priority_queue<std::pair<float, int32_t>>& heap) const {
    if (hi <= lo) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    const float* p = &pts[mid * 3];
    float d2 = dist2(q, p);
    if ((int)heap.size() < k) {
      heap.push({d2, idx[mid]});
    } else if (d2 < heap.top().first) {
      heap.pop();
      heap.push({d2, idx[mid]});
    }
    float delta = q[axis] - p[axis];
    int64_t near_lo = delta <= 0 ? lo : mid + 1;
    int64_t near_hi = delta <= 0 ? mid : hi;
    int64_t far_lo = delta <= 0 ? mid + 1 : lo;
    int64_t far_hi = delta <= 0 ? hi : mid;
    knn_rec(q, k, near_lo, near_hi, depth + 1, heap);
    if ((int)heap.size() < k || delta * delta < heap.top().first)
      knn_rec(q, k, far_lo, far_hi, depth + 1, heap);
  }

  void radius(const float* q, float r2, std::vector<int32_t>& out) const {
    radius_rec(q, r2, 0, n, 0, out);
  }

  void radius_rec(const float* q, float r2, int64_t lo, int64_t hi, int depth,
                  std::vector<int32_t>& out) const {
    if (hi <= lo) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    const float* p = &pts[mid * 3];
    if (dist2(q, p) <= r2) out.push_back(idx[mid]);
    float delta = q[axis] - p[axis];
    int64_t near_lo = delta <= 0 ? lo : mid + 1;
    int64_t near_hi = delta <= 0 ? mid : hi;
    int64_t far_lo = delta <= 0 ? mid + 1 : lo;
    int64_t far_hi = delta <= 0 ? hi : mid;
    radius_rec(q, r2, near_lo, near_hi, depth + 1, out);
    if (delta * delta <= r2) radius_rec(q, r2, far_lo, far_hi, depth + 1, out);
  }
};

}  // namespace

extern "C" {

void* kdtree_build(const float* points, int64_t n) {
  auto* t = new KDTree();
  t->build(points, n);
  return t;
}

void kdtree_free(void* tree) { delete static_cast<KDTree*>(tree); }

// queries [q*3] -> out_idx [q*k], out_d2 [q*k]
void kdtree_knn(void* tree, const float* queries, int64_t q, int32_t k,
                int32_t* out_idx, float* out_d2) {
  auto* t = static_cast<KDTree*>(tree);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < q; ++i)
    t->knn(&queries[i * 3], k, &out_idx[i * k], &out_d2[i * k]);
}

// Padded radius search: up to cap neighbors per query, counts uncapped.
void kdtree_radius(void* tree, const float* queries, int64_t q, float radius,
                   int32_t cap, int32_t* out_idx, int32_t* out_counts) {
  auto* t = static_cast<KDTree*>(tree);
  float r2 = radius * radius;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < q; ++i) {
    std::vector<int32_t> found;
    t->radius(&queries[i * 3], r2, found);
    out_counts[i] = (int32_t)found.size();
    int32_t m = std::min<int32_t>(cap, (int32_t)found.size());
    for (int32_t j = 0; j < m; ++j) out_idx[i * cap + j] = found[j];
    for (int32_t j = m; j < cap; ++j)
      out_idx[i * cap + j] = m ? found[0] : 0;
  }
}

}  // extern "C"
