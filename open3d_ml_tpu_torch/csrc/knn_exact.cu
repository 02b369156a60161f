// Exact k-NN by brute force: for each query, the k points with the smallest
// d2 = max(|q|^2 + |p|^2 - 2 q.p, 0), ascending, the lower point index first
// among equal distances. Masked points carry |p|^2 = 1e30.
//
// Replaces the TPU kernel open3d_ml_tpu/ops/pallas/knn.py, knn_pallas /
// _knn_kernel. Its contract, as knn_exact_plain in
// open3d_ml_tpu_torch/ops/cuda/knn.py states it, fixes one order for every
// sum: |x|^2 = (x0*x0 + x1*x1) + x2*x2 and q.p = (q0*p0 + q1*p1) + q2*p2.
// Here each product and sum is an explicit __fmul_rn / __fadd_rn, so no FMA
// contraction changes a bit and d2 equals the plain version's bit for bit.
//
// Bounds on the H100: RandLA-Net's eval pyramid asks N * N distances per
// level (45,056^2 = 2.0e9 at level 0), about ten float instructions each,
// from a point set of N * 16 bytes that stays in L2. The kernel is bound by
// instruction issue, and at one sample by occupancy: one thread per query
// gives 45,056 threads at level 0 (352 blocks for 132 SMs) and only 704 at
// level 3.
//
// Design: one thread per query, 128 queries per block. The block streams
// the points through shared memory in tiles of 1,024 as float4 (x, y, z,
// |p|^2), computing each norm once per block, and every thread of the block
// reads the same tile entry at the same time, a broadcast. A thread keeps
// its k best in registers as a sorted list (k is a template argument, so
// the list is fully unrolled). A candidate enters only when it is strictly
// nearer than the current k-th best and sinks only past strictly larger
// entries; points arrive in index order, so ties keep index order. Points
// are streamed, not held resident, so any N fits.
//
// Not carried over from the TPU kernel: the [TQ, k + TP] concatenation and
// its k min-extraction rounds (the TPU has no top-k), the broadcast-select
// column writes, and the zero-padded fourth coordinate for the MXU.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // queries per block, one per thread
constexpr int kTile = 1024;    // points per shared-memory tile (16 KB)
constexpr float kBig = 1e30f;  // |p|^2 of a masked point

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_exact_kernel(const float* __restrict__ points,
                     const float* __restrict__ queries,
                     const unsigned char* __restrict__ mask,
                     int* __restrict__ idx, float* __restrict__ d2, int n,
                     int q) {
  __shared__ float4 tile[kTile];
  const long long b = blockIdx.y;
  const float* pts = points + b * n * 3;
  const unsigned char* msk = mask == nullptr ? nullptr : mask + b * n;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  // threads past the last query still load tiles and meet every barrier
  const bool active = qi < q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = queries + (b * q + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float qn = sq_norm(qx, qy, qz);

  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = CUDART_INF_F;
    best_i[j] = 0;
  }
  for (int start = 0; start < n; start += kTile) {
    const int len = min(kTile, n - start);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const long long row = start + t;
      const float x = pts[row * 3 + 0];
      const float y = pts[row * 3 + 1];
      const float z = pts[row * 3 + 2];
      const bool valid = msk == nullptr || msk[row] != 0;
      tile[t] = make_float4(x, y, z, valid ? sq_norm(x, y, z) : kBig);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < len; ++t) {
      const float4 p = tile[t];
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
          __fmul_rn(qz, p.z));
      const float d = fmaxf(
          __fsub_rn(__fadd_rn(qn, p.w), __fmul_rn(2.0f, cross)), 0.0f);
      if (d < best_d[K - 1]) {
        best_d[K - 1] = d;
        best_i[K - 1] = start + t;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (best_d[j] < best_d[j - 1]) {
            const float td = best_d[j];
            best_d[j] = best_d[j - 1];
            best_d[j - 1] = td;
            const int ti = best_i[j];
            best_i[j] = best_i[j - 1];
            best_i[j - 1] = ti;
          }
        }
      }
    }
  }
  if (!active) return;
  int* idx_out = idx + (b * q + qi) * K;
  float* d2_out = d2 + (b * q + qi) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    idx_out[j] = best_i[j];
    d2_out[j] = best_d[j];
  }
}

}  // namespace

// points [B, N, 3] and queries [B, Q, 3] float32, mask [B, N] bool or null;
// idx [B, Q, k] int32 and d2 [B, Q, k] float32 are written. k must be 16.
extern "C" int knn_exact_launch(const float* points, const float* queries,
                                const unsigned char* mask, int* idx,
                                float* d2, int b, int n, int q, int k,
                                void* stream) {
  if (k != 16 || b < 1 || n < k || q < 1) return cudaErrorInvalidValue;
  const dim3 grid((q + kThreads - 1) / kThreads, b);
  knn_exact_kernel<16><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      points, queries, mask, idx, d2, n, q);
  return cudaGetLastError();
}
