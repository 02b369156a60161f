// Bucket KNN: the exact k nearest neighbours of each query inside its
// query block's candidate table.
//
// Replaces the TPU kernel open3d_ml_tpu/ops/pallas/bucket.py, knn_pallas /
// _knn_kernel. Its contract, as knn_bucket_plain in
// open3d_ml_tpu_torch/ops/cuda/bucket.py states it: block i of qblock
// queries searches the S segments seg_ids[b, i, :] of seg points each, a
// table of T = S * seg points; the result is, per query, the k table
// positions with the smallest d2 = dx*dx + dy*dy + dz*dz, ascending, the
// lower position first among equal distances.
//
// Bounds on the H100: each block computes qblock * T distances (128 * 2048
// at the shipped inference budget) from a table it reads once, so the
// kernel is bound by instruction issue (the distance, the compare against
// the k-th best and the insertion), not by device memory.
//
// Design: one thread block per (sample, query block). The block stages its
// table once in shared memory as three coordinate arrays (T * 12 bytes,
// 24 KB at S = 32, seg = 64), and every thread of the block then reads the
// same table entry at the same time, a broadcast. One thread owns one
// query and keeps its k best in registers as a sorted list (k is a template
// argument, so the list is fully unrolled). A candidate enters the list
// only when it is strictly nearer than the current k-th best and sinks
// only past strictly larger entries, which keeps ties in table order.
// d2 is computed with __fmul_rn / __fadd_rn in the plain version's order,
// so no FMA contraction changes a bit.
//
// Not carried over from the TPU kernel: the packed int32 distance/position
// keys of its min-extraction rounds (they truncate the low bits of d2),
// the broadcast-select column writes and the scalar-prefetch batch split.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <int K>
__global__ void bucket_knn_kernel(const float* __restrict__ points,
                                  const float* __restrict__ queries,
                                  const int* __restrict__ seg_ids,
                                  int* __restrict__ rel,
                                  float* __restrict__ d2, int npad, int q,
                                  int nqb, int s, int seg) {
  extern __shared__ float table[];
  const int t_rows = s * seg;
  float* tx = table;
  float* ty = table + t_rows;
  float* tz = table + 2 * t_rows;
  const int blk = blockIdx.x;
  const long long b = blockIdx.y;
  const int* sids = seg_ids + (b * nqb + blk) * s;
  const float* pts = points + b * npad * 3;
  for (int t = threadIdx.x; t < t_rows; t += blockDim.x) {
    const long long row = (long long)sids[t / seg] * seg + t % seg;
    tx[t] = pts[row * 3 + 0];
    ty[t] = pts[row * 3 + 1];
    tz[t] = pts[row * 3 + 2];
  }
  __syncthreads();

  const int qi = blk * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const float* qp = queries + (b * q + qi) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = CUDART_INF_F;
    best_i[j] = 0;
  }
  for (int t = 0; t < t_rows; ++t) {
    const float dx = __fsub_rn(qx, tx[t]);
    const float dy = __fsub_rn(qy, ty[t]);
    const float dz = __fsub_rn(qz, tz[t]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < best_d[K - 1]) {
      best_d[K - 1] = d;
      best_i[K - 1] = t;
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
  int* rel_out = rel + (b * q + qi) * K;
  float* d2_out = d2 + (b * q + qi) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    rel_out[j] = best_i[j];
    d2_out[j] = best_d[j];
  }
}

template <int K>
cudaError_t launch(const float* points, const float* queries,
                   const int* seg_ids, int* rel, float* d2, int b, int npad,
                   int q, int nqb, int s, int seg, int qblock,
                   cudaStream_t stream) {
  // at most the 48 KB a block gets without opting in (36 KB at the
  // training budget S = 48, seg = 64); the wrapper refuses larger tables
  const size_t smem = sizeof(float) * 3 * (size_t)s * seg;
  bucket_knn_kernel<K><<<dim3(nqb, b), qblock, smem, stream>>>(
      points, queries, seg_ids, rel, d2, npad, q, nqb, s, seg);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bucket_knn_launch(const float* points, const float* queries,
                                 const int* seg_ids, int* rel, float* d2,
                                 int b, int npad, int q, int nqb, int s,
                                 int seg, int qblock, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch<1>(points, queries, seg_ids, rel, d2, b, npad, q, nqb, s,
                       seg, qblock, st);
    case 16:
      return launch<16>(points, queries, seg_ids, rel, d2, b, npad, q, nqb,
                        s, seg, qblock, st);
    default:
      return cudaErrorInvalidValue;
  }
}
