// Bucket gather: the rows of each query's neighbours, read through its
// query block's candidate table.
//
// Replaces the forward of the TPU kernels in
// open3d_ml_tpu/ops/pallas/bucket.py, gather_pallas: _gather_kernel and
// _gather_flat_kernel. On the TPU a row gather was slow, so both built a
// one-hot matrix of the table positions and multiplied it with the table
// on the matrix unit; the two kernels differ only in how that product is
// tiled onto the unit (the flat one moves K into the product's rows and
// steps several query blocks at once when qblock < 128). A direct indexed
// load has no such difference, so one kernel serves both. Contract, as
// gather_bucket_plain in open3d_ml_tpu_torch/ops/cuda/bucket.py states it:
//
//   out[b, i, j, :] = values[b, seg_ids[b, i / qblock, r / seg] * seg
//                              + r % seg, :],   r = rel[b, i, j]
//
// with each value rounded to bfloat16 (and widened back) when round_bf16
// is set, as the TPU kernel's bf16 one-hot product rounded it.
//
// Bounds on the H100: device memory. There is no arithmetic; the
// [B, Q, K, C] float32 output goes through HBM once and is by far the
// largest tensor (127 MB at RandLA's training level 0, 2.2 GB at the
// SparseConvUnet level-0 convolutions of a batch of 8), while the values
// (8 MB at RandLA level 0) are read from L2 about K times each.
//
// Design (bucket_walk.cuh): threads over the flat [B * Q * K, C] output in
// memory order, so each warp stores 32 consecutive units and every line of
// the output is written whole whatever C is; each row's source row is
// computed once, by one lane, and handed to the row's other lanes by
// shuffle; each warp takes one tile, and the grid holds every tile. Two
// variants, both kernels: float4 units (16-byte loads and stores) where
// C % 4 == 0 and both pointers are 16-byte aligned (SCU's 32 to 224
// channels, RandLA's pool and upsample gathers), float units otherwise
// (RandLA's 11 and 35 channels). The output is stored with the
// streaming hint (__stcs): nothing reads it before the next operation, and
// at the sizes that matter it does not fit in L2. Shared memory would
// gain nothing: a query block reads about as many rows (qblock * K) as its
// table holds, so there is no reuse to stage, and the loads are served
// from L1 and L2 as they are.

#include <cuda_runtime.h>

#include "bucket_walk.cuh"

namespace {

// One warp per tile; the grid holds every tile.
template <typename T, bool kRound>
__global__ void __launch_bounds__(bucket::kThreads)
    bucket_gather_kernel(const T* __restrict__ values, T* __restrict__ out,
                         bucket::Tables t, int cu, int tile) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * tile;
  if (r0 >= t.rows) return;  // the whole warp
  const int nrows = (int)min((long long)tile, t.rows - r0);
  const int vrow = lane < nrows ? bucket::value_row(t, (int)r0 + lane) : 0;
  bucket::walk_tile(r0, nrows, cu, bucket::Steps(lane, cu), vrow,
                    [&](long long o, int v, int col, bool live) {
                      if (!live) return;
                      T x = __ldg(values + (long long)v * cu + col);
                      if (kRound) x = bucket::round_bf16(x);
                      __stcs(out + o, x);
                    });
}

template <typename T, bool kRound>
int launch(const float* values, float* out, const bucket::Tables& t, int cu,
           cudaStream_t stream) {
  const long long warps =
      bucket::resident_blocks<bucket_gather_kernel<T, kRound>>(0) *
      bucket::kWarpsPerBlock;
  const int tile = bucket::tile_rows(t.rows, cu, warps);
  const long long tiles = ((long long)t.rows + tile - 1) / tile;
  const unsigned blocks =
      (unsigned)((tiles + bucket::kWarpsPerBlock - 1) /
                 bucket::kWarpsPerBlock);
  bucket_gather_kernel<T, kRound><<<blocks, bucket::kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(values), reinterpret_cast<T*>(out), t, cu,
      tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bucket_gather_launch(const float* values, const int* seg_ids,
                                    const int* rel, float* out, int b,
                                    int npad, int q, int k, int c, int nqb,
                                    int s, int seg, int qblock,
                                    int round_bf16, int vec4, void* stream) {
  const bucket::Tables t{seg_ids, rel, b * q * k, npad, q, k, nqb, s, seg,
                         qblock};
  if (t.rows == 0 || c == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    return round_bf16 ? launch<float4, true>(values, out, t, c / 4, st)
                      : launch<float4, false>(values, out, t, c / 4, st);
  return round_bf16 ? launch<float, true>(values, out, t, c, st)
                    : launch<float, false>(values, out, t, c, st);
}
