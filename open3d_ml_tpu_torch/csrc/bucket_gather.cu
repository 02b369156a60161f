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
// Bounds on the H100: device memory. The kernel reads one row of C floats
// and writes one per output row, and the [B, Q, K, C] float32 output is
// the largest tensor it touches.
//
// Design: one warp per output row (b, i, j), its lanes over the channels,
// so a row is read and written by neighbouring lanes at neighbouring
// addresses. The warp computes the row's source index once. Rows whose C
// is much below 32 leave lanes idle; packing several rows into a warp is
// left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void bucket_gather_kernel(const float* __restrict__ values,
                                     const int* __restrict__ seg_ids,
                                     const int* __restrict__ rel,
                                     float* __restrict__ out, long long rows,
                                     int npad, int q, int k, int c, int nqb,
                                     int s, int seg, int qblock,
                                     int round_bf16) {
  const long long r =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bq = r / k;  // b * q + i
  const int i = (int)(bq % q);
  const long long b = bq / q;
  const int rv = rel[r];
  const long long sid = seg_ids[(b * nqb + i / qblock) * s + rv / seg];
  const float* src = values + (b * npad + sid * seg + rv % seg) * c;
  float* dst = out + r * c;
  for (int ch = lane; ch < c; ch += 32) {
    float v = src[ch];
    if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    dst[ch] = v;
  }
}

}  // namespace

extern "C" int bucket_gather_launch(const float* values, const int* seg_ids,
                                    const int* rel, float* out, int b,
                                    int npad, int q, int k, int c, int nqb,
                                    int s, int seg, int qblock,
                                    int round_bf16, void* stream) {
  const long long rows = (long long)b * q * k;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bucket_gather_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      values, seg_ids, rel, out, rows, npad, q, k, c, nqb, s, seg, qblock,
      round_bf16);
  return cudaGetLastError();
}
