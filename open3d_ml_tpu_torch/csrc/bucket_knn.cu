// Bucket KNN: the exact k nearest neighbours of each query inside its
// query block's candidate table.
//
// Replaces the TPU kernel open3d_ml_tpu/ops/pallas/bucket.py, knn_pallas /
// _knn_kernel. Its contract, as knn_bucket_plain in
// open3d_ml_tpu_torch/ops/cuda/bucket.py states it: block i of qblock
// queries searches the S segments seg_ids[b, i, :] of seg points each, a
// table of T = S * seg points; the result is, per query, the k table
// positions with the smallest d2 = dx*dx + dy*dy + dz*dz, ascending, the
// lower position first among equal distances. d2 is computed with
// __fmul_rn / __fadd_rn in the plain version's order, so no FMA
// contraction changes a bit.
//
// Bounds on the H100: each query block computes qblock * T distances
// (128 * 2048 at the shipped inference budget) from a table it reads once,
// so the kernel is bound by instruction issue: 8 float instructions per
// distance, a compare and a bit of the hit mask, and the shared load of
// the candidate, which serves all of a thread's queries.
//
// Design: grid (query blocks, groups, B). Block g of a query block stages
// table positions [g * span, (g + 1) * span) in shared memory as float4
// (x, y, z, 0), one 16-byte store per row, the row found with a shift and
// a mask (seg is a power of two). A thread owns QPT queries of the block
// (1, or 2 past 512 queries a block: thread t the queries t, t + threads),
// reads each table entry once for all of them as every thread of the
// block reads it, a broadcast, and keeps their k best in registers,
// inserting through hit masks (knn_select.cuh). With one group a block
// writes rel and d2; with more, the deep levels' few query blocks are
// spread over more blocks, each posts its lists to part_* and the last
// block of the query block to finish merges them by (d2, position): one
// launch a call either way.
//
// k is 1, 3, 8 or 16, each its own instance: the lists hold K = 1, 4, 8 or
// 16 entries (knn_select.cuh's bitonic sort and merge need a power of
// two) and a query writes the first k of its list. The exact K best by
// (d2, position) hold the exact k best as their first k, so k = 3 keeps
// the tie rule of k = 16. RandLA-Net asks for k = 16 and 1;
// PointTransformer's pyramid for k = 8 (level-0 attention), 16 and 3 (its
// 3-NN upsample), over tables of up to 64 segments of 64 points (66,048
// bytes of shared memory a block, past the 48 KB default: the launch opts
// in).
//
// Not carried over from the TPU kernel: the packed int32 distance/position
// keys of its min-extraction rounds (they truncate the low bits of d2),
// the broadcast-select column writes and the scalar-prefetch batch split.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"

namespace {

using knn_select::TopK;
using knn_select::kBatch;

// Shared memory of a block staging ``rows`` table rows, and a batch of
// slack that the last batch may read past the end.
constexpr size_t shared_bytes(int rows) {
  return ((size_t)rows + kBatch) * sizeof(float4);
}

constexpr int kStage = 8;  // table rows a thread stages at a time

__device__ __forceinline__ float pair_d2(float qx, float qy, float qz,
                                         float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// threads a block at most: 128 registers a thread
constexpr int kMaxThreads = 512;

// K: the list's entries, k <= K of them written. SPLIT: a query block's
// table is split over gridDim.y > 1 blocks, which post their lists of K
// and the last of them to finish merges them (compiled apart, so the
// kernel of an unsplit call carries none of it)
template <int K, int QPT, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads)
    bucket_knn_kernel(const float* __restrict__ points,
                      const float* __restrict__ queries,
                      const int* __restrict__ seg_ids, int* __restrict__ rel,
                      float* __restrict__ d2, int* __restrict__ part_i,
                      float* __restrict__ part_d,
                      unsigned* __restrict__ tickets, int npad, int q,
                      int nqb, int s, int seg_shift, int qblock, int k,
                      int span) {
  extern __shared__ float4 table[];
  const int blk = blockIdx.x, g = blockIdx.y;
  const long long b = blockIdx.z;
  const int seg_mask = (1 << seg_shift) - 1;
  const int lo = g * span, hi = min(s << seg_shift, lo + span);
  const int rows = hi - lo;
  const int* sids = seg_ids + (b * nqb + blk) * s;
  const float* pts = points + b * npad * 3;
  // kStage rows a thread at a time, all their loads in flight
  for (int t0 = threadIdx.x; t0 < rows; t0 += kStage * blockDim.x) {
    float4 staged[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int pos = lo + t0 + u * blockDim.x;
      if (pos < hi) {
        const long long row = ((long long)sids[pos >> seg_shift]
                               << seg_shift) + (pos & seg_mask);
        staged[u] = make_float4(pts[row * 3 + 0], pts[row * 3 + 1],
                                pts[row * 3 + 2], 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (t0 + u * blockDim.x < rows) table[t0 + u * blockDim.x] = staged[u];
  }
  __syncthreads();

  float qx[QPT], qy[QPT], qz[QPT];
  int qi[QPT];
  bool any = false;
  TopK<K> top[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int inblk = threadIdx.x + u * blockDim.x;
    qi[u] = inblk < qblock ? blk * qblock + inblk : q;
    qx[u] = qy[u] = qz[u] = 0.f;
    if (qi[u] < q) {
      const float* qp = queries + (b * q + qi[u]) * 3;
      qx[u] = qp[0];
      qy[u] = qp[1];
      qz[u] = qp[2];
      any = true;
    }
    top[u].clear();
  }
  // threads without a query skip the scan; with SPLIT they still meet the
  // ticket's barriers
  if (!SPLIT && !any) return;

  const int first = min(rows, K);
  if (any) {
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      top[u].seed(first, lo, [&](int j) {
        return pair_d2(qx[u], qy[u], qz[u], table[j]);
      });
    }
  }
  for (int t0 = first; any && t0 < rows; t0 += kBatch) {
    unsigned hits[QPT];
    float thr[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      hits[u] = 0u;
      thr[u] = top[u].d[K - 1];
    }
    // entries past the slice's end are stale; their bits are cleared below
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float4 p = table[t0 + j];
#pragma unroll
      for (int u = 0; u < QPT; ++u)
        if (pair_d2(qx[u], qy[u], qz[u], p) < thr[u]) hits[u] |= 1u << j;
    }
    const unsigned valid = knn_select::batch_bits(rows - t0);
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      knn_select::insert_hits(top[u], hits[u] & valid, CUDART_INF_F, lo + t0,
                              [&](int j) {
                                return pair_d2(qx[u], qy[u], qz[u],
                                               table[t0 + j]);
                              });
    }
  }

  if constexpr (SPLIT) {
    const int groups = gridDim.y;
    // the list of query u from block g2 of this query block
    auto part = [&](int g2, int u) {
      return ((g2 * (long long)gridDim.z + b) * q + qi[u]) * K;
    };
#pragma unroll
    for (int u = 0; u < QPT; ++u)
      if (qi[u] < q) top[u].store(part_d + part(g, u), part_i + part(g, u), 1);
    if (!knn_select::took_last_ticket(tickets + b * nqb + blk, groups)) return;
    for (int g2 = 0; g2 < groups; ++g2) {
      if (g2 == g) continue;
#pragma unroll
      for (int u = 0; u < QPT; ++u)
        if (qi[u] < q)
          top[u].merge_posted(part_d + part(g2, u), part_i + part(g2, u));
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    if (qi[u] >= q) continue;
    const long long at = (b * q + qi[u]) * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        d2[at + j] = top[u].d[j];
        rel[at + j] = top[u].i[j];
      }
    }
  }
}

template <int K, int QPT>
cudaError_t launch(const float* points, const float* queries,
                   const int* seg_ids, int* rel, float* d2, int* part_i,
                   float* part_d, unsigned* tickets, int b, int npad, int q,
                   int nqb, int s, int seg_shift, int qblock, int k,
                   int threads, int groups, int span, size_t shared,
                   cudaStream_t stream) {
  if (threads * QPT < qblock || threads > kMaxThreads || k < 1 || k > K)
    return cudaErrorInvalidValue;
  const auto kernel = groups > 1 ? bucket_knn_kernel<K, QPT, true>
                                  : bucket_knn_kernel<K, QPT, false>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nqb, groups, b), threads, shared, stream>>>(
      points, queries, seg_ids, rel, d2, part_i, part_d, tickets, npad, q,
      nqb, s, seg_shift, qblock, k, span);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(int qpt, const float* points, const float* queries,
                     const int* seg_ids, int* rel, float* d2, int* part_i,
                     float* part_d, unsigned* tickets, int b, int npad, int q,
                     int nqb, int s, int seg_shift, int qblock, int k,
                     int threads, int groups, int span, size_t shared,
                     cudaStream_t st) {
  switch (qpt) {
    case 1:
      return launch<K, 1>(points, queries, seg_ids, rel, d2, part_i, part_d,
                          tickets, b, npad, q, nqb, s, seg_shift, qblock, k,
                          threads, groups, span, shared, st);
    case 2:
      return launch<K, 2>(points, queries, seg_ids, rel, d2, part_i, part_d,
                          tickets, b, npad, q, nqb, s, seg_shift, qblock, k,
                          threads, groups, span, shared, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory in bytes of a block that stages ``rows`` table rows: the
// one formula, which the wrapper reads for its launch and its checks.
extern "C" int bucket_knn_shared(int rows) {
  return rows < 1 ? 0 : (int)shared_bytes(rows);
}

// points [B, npad, 3], queries [B, Q, 3] float32, seg_ids [B, nqb, S]
// int32; rel [B, Q, k] int32 and d2 [B, Q, k] float32 are written, k 1,
// 3, 8 or 16. seg = 1 << seg_shift. The plan (ops/cuda/bucket.py, bucket_knn_plan):
// qpt queries a thread (1 or 2), threads a block (at most 512, threads *
// qpt >= qblock), groups blocks per query block, each over span table
// positions ((groups - 1) * span < S * seg <= groups * span), ``shared`` bytes
// as bucket_knn_shared(span) gives them. With groups > 1 part_i and part_d
// hold [groups, B, Q, K] for the blocks' lists of K = 1, 4, 8 or 16
// entries (ops/cuda/bucket.py, knn_list) and tickets [B * nqb] are 0 (the
// kernel leaves them 0).
extern "C" int bucket_knn_launch(const float* points, const float* queries,
                                 const int* seg_ids, int* rel, float* d2,
                                 int* part_i, float* part_d, unsigned* tickets,
                                 int b, int npad, int q, int nqb, int s,
                                 int seg_shift, int qblock, int k, int qpt,
                                 int threads, int groups, int span,
                                 int shared, void* stream) {
  const long long t_rows = (long long)s << seg_shift;
  if (b < 1 || b > 65535 || q < 1 || s < 1 || seg_shift < 0 ||
      seg_shift > 20 || qblock < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || groups < 1 || groups > 65535 || span < 1 ||
      (long long)(groups - 1) * span >= t_rows ||
      (long long)groups * span < t_rows || nqb != (q + qblock - 1) / qblock ||
      shared != bucket_knn_shared(span) ||
      (groups > 1 &&
       (part_i == nullptr || part_d == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch_k<1>(qpt, points, queries, seg_ids, rel, d2, part_i,
                         part_d, tickets, b, npad, q, nqb, s, seg_shift,
                         qblock, k, threads, groups, span, shared, st);
    case 3:
      return launch_k<4>(qpt, points, queries, seg_ids, rel, d2, part_i,
                         part_d, tickets, b, npad, q, nqb, s, seg_shift,
                         qblock, k, threads, groups, span, shared, st);
    case 8:
      return launch_k<8>(qpt, points, queries, seg_ids, rel, d2, part_i,
                         part_d, tickets, b, npad, q, nqb, s, seg_shift,
                         qblock, k, threads, groups, span, shared, st);
    case 16:
      return launch_k<16>(qpt, points, queries, seg_ids, rel, d2, part_i,
                          part_d, tickets, b, npad, q, nqb, s, seg_shift,
                          qblock, k, threads, groups, span, shared, st);
    default:
      return cudaErrorInvalidValue;
  }
}
