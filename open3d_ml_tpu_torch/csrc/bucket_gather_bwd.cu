// Bucket gather backward: every cotangent row of the gather's output is
// added into the value row it was read from.
//
// Replaces the backward of gather_pallas in open3d_ml_tpu/ops/pallas/
// bucket.py: _gather_bwd_kernel and _gather_bwd_flat_kernel, and the
// segment-granular scatter-add of their partial tables (_gather_bwd). On
// the TPU a row scatter was slow, so each query block built its table's
// gradient as the transposed one-hot product one-hot^T x g on the matrix
// unit (K products of [qb, table]^T x [qb, C], or one [qb*K, table]^T x
// [qb*K, C] product over `group` blocks when qblock < 128), and a second
// pass added the nqb * S partial [seg, C] chunks into dvalues. The two
// kernels differ only in how the product is tiled onto the unit; an atomic
// row add has no such difference, so one kernel serves both. Contract, as
// gather_bucket_bwd_plain in open3d_ml_tpu_torch/ops/cuda/bucket.py
// states it:
//
//   dvalues[b, seg_ids[b, i / qblock, r / seg] * seg + r % seg, :]
//       += g[b, i, j, :],   r = rel[b, i, j]
//
// over every (b, i, j), with dvalues zeroed by the wrapper and each g value
// rounded to bfloat16 first when round_bf16 is set, as the TPU kernel's
// bf16 product rounded the cotangents (it accumulated in float32).
//
// Bounds on the H100: device memory. The [B, Q, K, C] float32 read of g
// is the largest tensor (127 MB at RandLA's training level 0, 2.2 GB at
// the SparseConvUnet level-0 convolutions of a batch of 8); one float add
// per g value, done in L2 by the atomics, where dvalues stays. In practice
// the atomics set the pace where C is small: each value row has about K
// readers, and neighbouring queries, which run at the same time, share
// most of them.
//
// Design (bucket_walk.cuh), as in bucket_gather.cu: threads over the flat
// [B * Q * K, C] cotangent in memory order, so each warp reads 32
// consecutive units whatever C is and adds them into value rows whose
// index one lane computes per row and shuffles to the others. A warp's
// atomics to consecutive addresses of one value row are merged into one
// L2 request per 32-byte sector. Each warp walks a run of consecutive
// tiles, so that the warps that run at once work on rows far apart. Two
// variants, both kernels:
//
// - float4 units, where C % 4 == 0 and both pointers are 16-byte aligned
//   (SparseConvUnet, RandLA's pool and upsample): 16-byte loads and the
//   16-byte vector atomic add of compute capability 9.x, one L2 operation
//   for four channels;
// - float units otherwise (RandLA's 11 and 35 channels): scalar atomicAdd
//   whose result is unused, so that it compiles to a reduction (RED) that
//   does not wait for the sum.
//
// Units that are all zeros are not added: a sum that starts at +0 keeps
// its bits when ±0 is added, and the cotangents of SparseConvUnet's
// missed taps, masked to 0, all point at one row per table, where their
// adds would queue on the same addresses. Shared memory holds no gain
// here: summing a block's or a warp's rows in a shared-memory table
// before the global atomics, and packing a row's float units into 16-byte
// atomics padded with zeros, were both slower on the H100 (shared-memory
// float atomics queue on the hot slots; padded vectors add requests).
//
// The sums are taken in an order that changes from run to run, so the
// result is exact only where every partial sum is (dyadic cotangents);
// otherwise it differs from a fixed-order sum by float32 rounding. A
// deterministic owner-computes design, in which each value row sums its
// readers in a fixed order over a CSR index built from the targets, needs
// a per-call inverse of the tables and is left for later.

#include <cuda_runtime.h>

#include "bucket_walk.cuh"

namespace {

// Each warp walks a run of consecutive tiles (of `tile` rows), so that
// the warps that run at once work on rows far apart.
template <class Op>
__device__ __forceinline__ void walk_runs(const bucket::Tables& t, int cu,
                                          int tile, Op op) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const bucket::Steps st(lane, cu);
  const long long tiles = (t.rows + tile - 1) / tile;
  const long long per = (tiles + warps - 1) / warps;
  const long long end = min(tiles, (warp + 1) * per) * tile;
  for (long long r0 = warp * per * tile; r0 < end; r0 += tile) {
    const int nrows = (int)min((long long)tile, t.rows - r0);
    const int vrow = lane < nrows ? bucket::value_row(t, (int)r0 + lane) : 0;
    bucket::walk_tile(r0, nrows, cu, st, vrow, op);
  }
}

__device__ __forceinline__ bool nonzero(float4 x) {
  return x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f;
}

template <bool kRound>
__global__ void __launch_bounds__(bucket::kThreads)
    bucket_gather_bwd_vec_kernel(const float4* __restrict__ g,
                                 float4* __restrict__ dvalues,
                                 bucket::Tables t, int cu, int tile) {
  walk_runs(t, cu, tile, [&](long long o, int v, int col, bool live) {
    if (!live) return;
    float4 x = __ldcs(g + o);
    if (kRound) x = bucket::round_bf16(x);
    if (nonzero(x)) atomicAdd(dvalues + (long long)v * cu + col, x);
  });
}

template <bool kRound>
__global__ void __launch_bounds__(bucket::kThreads)
    bucket_gather_bwd_kernel(const float* __restrict__ g,
                             float* __restrict__ dvalues, bucket::Tables t,
                             int c, int tile) {
  walk_runs(t, c, tile, [&](long long o, int v, int col, bool live) {
    if (!live) return;
    float x = __ldcs(g + o);
    if (kRound) x = bucket::round_bf16(x);
    if (x != 0.f) atomicAdd(dvalues + (long long)v * c + col, x);
  });
}

// Launches kKernel over runs of tiles: the blocks the device holds at
// once, or fewer where there are fewer tiles.
template <auto kKernel, typename T>
int launch_runs(const float* g, float* dvalues, const bucket::Tables& t,
                int cu, cudaStream_t stream) {
  const long long resident = bucket::resident_blocks<kKernel>(0);
  const int tile =
      bucket::tile_rows(t.rows, cu, resident * bucket::kWarpsPerBlock);
  const long long tiles = ((long long)t.rows + tile - 1) / tile;
  const long long need =
      (tiles + bucket::kWarpsPerBlock - 1) / bucket::kWarpsPerBlock;
  kKernel<<<(unsigned)(need < resident ? need : resident), bucket::kThreads,
            0, stream>>>(reinterpret_cast<const T*>(g),
                         reinterpret_cast<T*>(dvalues), t, cu, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bucket_gather_bwd_launch(const float* g, const int* seg_ids,
                                        const int* rel, float* dvalues,
                                        int b, int npad, int q, int k, int c,
                                        int nqb, int s, int seg, int qblock,
                                        int round_bf16, int vec4,
                                        void* stream) {
  const bucket::Tables t{seg_ids, rel, b * q * k, npad, q, k, nqb, s, seg,
                         qblock};
  if (t.rows == 0 || c == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    return round_bf16
               ? launch_runs<bucket_gather_bwd_vec_kernel<true>, float4>(
                     g, dvalues, t, c / 4, st)
               : launch_runs<bucket_gather_bwd_vec_kernel<false>, float4>(
                     g, dvalues, t, c / 4, st);
  return round_bf16
             ? launch_runs<bucket_gather_bwd_kernel<true>, float>(
                   g, dvalues, t, c, st)
             : launch_runs<bucket_gather_bwd_kernel<false>, float>(
                   g, dvalues, t, c, st);
}
