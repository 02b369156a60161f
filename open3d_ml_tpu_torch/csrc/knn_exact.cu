// Exact k-NN by brute force: for each query, the k points with the smallest
// d2 = max(|q|^2 + |p|^2 - 2 q.p, 0), ascending, the lower point index first
// among equal distances. Masked points carry |p|^2 = 1e30.
//
// Replaces the TPU kernel open3d_ml_tpu/ops/pallas/knn.py, knn_pallas /
// _knn_kernel. Its contract, as knn_exact_plain in
// open3d_ml_tpu_torch/ops/cuda/knn.py states it, fixes one order for every
// sum: |x|^2 = (x0*x0 + x1*x1) + x2*x2 and q.p = (q0*p0 + q1*p1) + q2*p2.
// Here each product and sum is an explicit __fmul_rn / __fadd_rn, so no FMA
// contraction changes a bit. The last step, (|q|^2 + |p|^2) - 2 (q.p), is
// one __fmaf_rn(-2, q.p, |q|^2 + |p|^2): 2 (q.p) is exact in float32 (a
// power-of-two scale needs no rounding short of overflow, past coordinates
// of ~1e19), so the fused form rounds once where the plain version rounds
// once, and d2 equals the plain version's bit for bit.
//
// Bounds on the H100: RandLA-Net's eval pyramid asks N * N distances per
// level (45,056^2 = 2.0e9 at level 0) from a point set of N * 16 bytes that
// stays in L2, so the kernel is bound by instruction issue: 7 float
// instructions per distance, a compare and a bit of the hit mask, and a
// shared load per 32 distances (or 64, two queries a thread). At one
// sample the eval pyramid's levels hold 45,056 / 11,264 / 2,816 / 704
// queries: one thread per query would leave most SMs idle at levels 1-3.
//
// Design: a warp holds 32 queries (64 with two a thread) and scans one
// slice of the candidates; the slices of one query are the warps of a
// block. Grid (query groups, B). The block streams the N candidates
// through shared memory in tiles of warps * chunk as float4 (x, y, z,
// |p|^2), each norm computed once per block; warp w takes tile entries
// [w * chunk, (w + 1) * chunk),
// every lane reading the same entry at the same time, a broadcast. A
// thread keeps its k best in registers and inserts through hit masks
// (knn_select.cuh). After each tile the warps of a block post two values
// of their lists; each query then reads the least of the warps' k-th best
// and the largest of their ceil(k / warps)-th best, both upper bounds of
// its k-th best over the whole block (the second because warps *
// ceil(k / warps) >= k distinct candidates lie at or below it), and no
// slice inserts a candidate above that bound. At the end the warps' lists
// merge in a tree by (d2, index) and warp 0 writes idx and d2. A split of
// a query group's candidates over blocks as well, the last block to finish
// merging their lists, measured no faster on the H100 than up to 8 warps
// in one block at the eval pyramid's small levels, so there is none.
//
// Not carried over from the TPU kernel: the [TQ, k + TP] concatenation and
// its k min-extraction rounds (the TPU has no top-k), the broadcast-select
// column writes, and the zero-padded fourth coordinate for the MXU.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"

namespace {

using knn_select::TopK;

constexpr int kK = 16;         // the one k the kernel is built for
constexpr int kMaxWarps = 8;   // warps of a block (a power of two)
constexpr int kMaxChunk = 128; // tile entries per warp, a multiple of 32
constexpr float kBig = 1e30f;  // |p|^2 of a masked point

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// d2 before the clamp at 0: (|q|^2 + |p|^2) - 2 q.p in the contract's order
__device__ __forceinline__ float raw_d2(float qx, float qy, float qz,
                                        float qn, float4 p) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
  return __fmaf_rn(-2.0f, cross, __fadd_rn(qn, p.w));
}

// Shared memory of a block of nw warps with QPT queries a thread: the tile
// (and a batch of slack, which a warp's last batch may read past its end),
// reused by the merge, and the posted bounds (two parities x two values).
template <int QPT>
__host__ __device__ constexpr size_t shared_bytes(int nw, int chunk) {
  const size_t tile =
      ((size_t)nw * chunk + knn_select::kBatch) * sizeof(float4);
  const size_t merge = knn_select::tree_merge_bytes<kK, QPT>(nw);
  return (tile > merge ? tile : merge) +
         (size_t)2 * 2 * nw * 32 * QPT * sizeof(float);
}

template <int QPT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    knn_exact_kernel(const float* __restrict__ points,
                     const float* __restrict__ queries,
                     const unsigned char* __restrict__ mask,
                     int* __restrict__ idx, float* __restrict__ d2,
                     int n, int q, int chunk) {
  extern __shared__ float4 smem[];
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const long long b = blockIdx.y;
  const float* pts = points + b * n * 3;
  const unsigned char* msk = mask == nullptr ? nullptr : mask + b * n;
  float4* tile = smem;
  const size_t tile_bytes =
      shared_bytes<QPT>(nw, chunk) - (size_t)2 * 2 * nw * 32 * QPT * 4;
  // posts[parity][value][warp][slot], slot = s * 32 + lane
  float* posts = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem) + tile_bytes);
  const int post_stride = nw * 32 * QPT;

  // lanes past the last query scan as a query at the origin and write
  // nothing; they meet every barrier
  float qx[QPT], qy[QPT], qz[QPT], qn[QPT], lim[QPT];
  int qi[QPT];
  TopK<kK> top[QPT];
#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    qi[s] = blockIdx.x * 32 * QPT + s * 32 + lane;
    qx[s] = qy[s] = qz[s] = 0.f;
    if (qi[s] < q) {
      const float* qp = queries + (b * q + qi[s]) * 3;
      qx[s] = qp[0];
      qy[s] = qp[1];
      qz[s] = qp[2];
    }
    qn[s] = sq_norm(qx[s], qy[s], qz[s]);
    lim[s] = CUDART_INF_F;
    top[s].clear();
  }
  // the entry each warp posts besides its k-th: the ceil(k / nw)-th
  const int jpost = (kK + nw - 1) / nw - 1;

  int parity = 0;
  bool seeded = false;  // whether this warp's lists hold candidates yet
  for (int start = 0; start < n; start += nw * chunk) {
    const int len = min(nw * chunk, n - start);
    // at most kMaxChunk / 32 entries a thread, all their loads in flight
    constexpr int kPer = kMaxChunk / 32;
    float4 staged[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long row = start + threadIdx.x + u * blockDim.x;
      if (row < start + len) {
        const float x = pts[row * 3 + 0];
        const float y = pts[row * 3 + 1];
        const float z = pts[row * 3 + 2];
        const bool valid = msk == nullptr || msk[row] != 0;
        staged[u] = make_float4(x, y, z, valid ? sq_norm(x, y, z) : kBig);
      }
    }
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = threadIdx.x + u * blockDim.x;
      if (t < len) tile[t] = staged[u];
    }
    __syncthreads();
    if (nw > 1 && start > 0) {
      // the bounds the warps posted after the previous tile
      const float* own = posts + (parity ^ 1) * 2 * post_stride;
#pragma unroll
      for (int s = 0; s < QPT; ++s) {
        float least = CUDART_INF_F, most = 0.f;
        for (int w = 0; w < nw; ++w) {
          least = fminf(least, own[w * 32 * QPT + s * 32 + lane]);
          most = fmaxf(most, own[post_stride + w * 32 * QPT + s * 32 + lane]);
        }
        lim[s] = knn_select::next_up(fminf(least, most));
      }
    }
    const int c0 = warp * chunk, c1 = min(len, c0 + chunk);
    int first = c0;
    if (!seeded && c1 > c0) {
      first = min(c1, c0 + kK);
#pragma unroll
      for (int s = 0; s < QPT; ++s) {
        top[s].seed(first - c0, start + c0, [&](int j) {
          return fmaxf(raw_d2(qx[s], qy[s], qz[s], qn[s], tile[c0 + j]), 0.0f);
        });
      }
      seeded = true;
    }
    for (int t0 = first; t0 < c1; t0 += knn_select::kBatch) {
      const unsigned valid = knn_select::batch_bits(c1 - t0);
      unsigned hits[QPT];
      float thr[QPT];
#pragma unroll
      for (int s = 0; s < QPT; ++s) {
        hits[s] = 0u;
        thr[s] = fminf(top[s].d[kK - 1], lim[s]);
      }
      // entries past the tile's end are stale; their bits are cleared below
#pragma unroll
      for (int j = 0; j < knn_select::kBatch; ++j) {
        const float4 p = tile[t0 + j];
#pragma unroll
        for (int s = 0; s < QPT; ++s) {
          if (raw_d2(qx[s], qy[s], qz[s], qn[s], p) < thr[s])
            hits[s] |= 1u << j;
        }
      }
#pragma unroll
      for (int s = 0; s < QPT; ++s) {
        knn_select::insert_hits(
            top[s], hits[s] & valid, lim[s], start + t0, [&](int j) {
              return fmaxf(raw_d2(qx[s], qy[s], qz[s], qn[s], tile[t0 + j]),
                           0.0f);
            });
      }
    }
    if (nw > 1) {
      float* mine = posts + parity * 2 * post_stride + warp * 32 * QPT + lane;
#pragma unroll
      for (int s = 0; s < QPT; ++s) {
        float part = top[s].d[kK - 1];
#pragma unroll
        for (int j = 0; j < kK; ++j)
          if (j == jpost) part = top[s].d[j];
        mine[s * 32] = top[s].d[kK - 1];
        mine[post_stride + s * 32] = part;
      }
    }
    parity ^= 1;
  }

  knn_select::tree_merge<kK, QPT>(top, smem, nw, warp, lane);
  if (warp != 0) return;
#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    if (qi[s] >= q) continue;
    const long long at = (b * q + qi[s]) * kK;
    top[s].store(d2 + at, idx + at, 1);
  }
}

template <int QPT>
cudaError_t launch(const float* points, const float* queries,
                   const unsigned char* mask, int* idx, float* d2,
                   int b, int n, int q, int warps, int chunk,
                   cudaStream_t stream) {
  const size_t shared = shared_bytes<QPT>(warps, chunk);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_exact_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((q + 32 * QPT - 1) / (32 * QPT), b);
  knn_exact_kernel<QPT><<<grid, warps * 32, shared, stream>>>(
      points, queries, mask, idx, d2, n, q, chunk);
  return cudaGetLastError();
}

}  // namespace

// points [B, N, 3] and queries [B, Q, 3] float32, mask [B, N] bool or null;
// idx [B, Q, k] int32 and d2 [B, Q, k] float32 are written. k must be 16.
// The plan (ops/cuda/knn.py, exact_plan): qpt queries a thread (1 or 2),
// warps a block (1, 2, 4 or 8), chunk tile entries a warp (a multiple of
// 32, at most 128).
extern "C" int knn_exact_launch(const float* points, const float* queries,
                                const unsigned char* mask, int* idx,
                                float* d2, int b, int n, int q, int k,
                                int qpt, int warps, int chunk, void* stream) {
  const bool pow2 = warps > 0 && (warps & (warps - 1)) == 0;
  if (k != kK || b < 1 || b > 65535 || n < k || q < 1 || !pow2 ||
      warps > kMaxWarps || chunk < 32 || chunk > kMaxChunk || chunk % 32)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qpt) {
    case 1:
      return launch<1>(points, queries, mask, idx, d2, b, n, q, warps, chunk,
                       st);
    case 2:
      return launch<2>(points, queries, mask, idx, d2, b, n, q, warps, chunk,
                       st);
    default:
      return cudaErrorInvalidValue;
  }
}
