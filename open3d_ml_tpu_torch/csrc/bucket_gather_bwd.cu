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
// Bounds on the H100: the [B, Q, K, C] float32 read of g (the largest
// tensor), and float atomics that land in L2: each value row has about K
// readers, so about K adds reach every dvalues word.
//
// Design: one warp per cotangent row (b, i, j), its lanes over the
// channels, as in bucket_gather.cu: the warp computes the row's target once
// and its lanes add to neighbouring addresses. The sums are taken in an
// order that changes from run to run, so the result is exact only where
// every partial sum is (dyadic cotangents); otherwise it differs from a
// fixed-order sum by float32 rounding. A deterministic owner-computes
// design, in which each value row sums its readers in a fixed order over a
// CSR index built from the targets, is left for a performance change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void bucket_gather_bwd_kernel(const float* __restrict__ g,
                                         const int* __restrict__ seg_ids,
                                         const int* __restrict__ rel,
                                         float* __restrict__ dvalues,
                                         long long rows, int npad, int q,
                                         int k, int c, int nqb, int s,
                                         int seg, int qblock,
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
  float* dst = dvalues + (b * npad + sid * seg + rv % seg) * c;
  const float* src = g + r * c;
  for (int ch = lane; ch < c; ch += 32) {
    float v = src[ch];
    if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    atomicAdd(dst + ch, v);
  }
}

}  // namespace

extern "C" int bucket_gather_bwd_launch(const float* g, const int* seg_ids,
                                        const int* rel, float* dvalues,
                                        int b, int npad, int q, int k, int c,
                                        int nqb, int s, int seg, int qblock,
                                        int round_bf16, void* stream) {
  const long long rows = (long long)b * q * k;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bucket_gather_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      g, seg_ids, rel, dvalues, rows, npad, q, k, c, nqb, s, seg, qblock,
      round_bf16);
  return cudaGetLastError();
}
