// Stencil convolution: match + gather + product of SparseConvUnet's
// submanifold, down and up convolutions, fused in one kernel.
//
// Replaces the TPU kernel in open3d_ml_tpu/ops/pallas/stencil.py,
// stencil_conv_pallas: _conv_kernel. Contract, as stencil_conv_plain in
// open3d_ml_tpu_torch/ops/cuda/stencil.py states it:
//
//   out[b, i, :] = sum_k values[b, row(qkeys[b, i, k]), :] @ w[k]
//
// where row(key) is the row of block i / qblock's candidate table (the S
// segments seg_ids[b, i / qblock] of seg rows each) whose Morton key equals
// the tap key; a miss contributes 0. With round_bf16 the values and the
// weights are rounded to bfloat16 first, so each product is exact in
// float32; the sums are float32.
//
// On the TPU a row gather was slow, so the kernel built a one-hot matrix
// of key equality [K * qblock, table] and multiplied it with the table on
// the matrix unit. On Hopper an indexed load is cheap, so this kernel
// resolves each tap's row directly and reads that row.
//
// Bounds on the H100: the bytes are small (at level 0 of the ScanNet
// config, a 27-tap 32 -> 32 convolution reads values and tap keys and
// writes its output, about 15 MB, 4.5 us at 3.35 TB/s), and the products
// of the found taps are about 2 GFLOP, 2 us at the bf16 tensor-core rate.
// This kernel runs its products on the CUDA cores in float32 (67 TFLOP/s
// at most), so it is bound by operations; a wgmma version is later work.
//
// Design: one block per (query block, tile of CT output channels, batch
// row), 256 threads.
// 1. The table's keys (at most 1024) go to shared memory. Keys ascend
//    within each segment (the sites are Morton-sorted and pad keys are
//    INT32_MAX at the end), so each tap is resolved by a range check and a
//    binary search per segment; its value row, or -1, goes to shared
//    memory, and a mask records which taps found a row anywhere in the
//    block. A tap that no query of the block found is skipped below.
// 2. For each live tap and each chunk of 32 input channels, the matched
//    value rows (0 for a miss) and the weight tile go to shared memory,
//    and each thread accumulates a RQ x 4 tile of outputs in float32
//    registers (RQ queries spaced NQG apart, 4 adjacent channels).
// The shared memory stays within the 48 KB a block gets without opting
// in; the wrapper checks the limits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // input channels staged per step
constexpr int kVStride = kChunk + 1;  // padded row: no bank conflicts

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int CT, int RQ>
__global__ void __launch_bounds__(kThreads)
    stencil_conv_kernel(const float* __restrict__ values,
                        const int* __restrict__ keys,
                        const int* __restrict__ qkeys,
                        const int* __restrict__ seg_ids,
                        const float* __restrict__ w, float* __restrict__ out,
                        int v, int npad, int q, int k, int cin, int cout,
                        int nqb, int s, int seg, int qblock, int round_bf16) {
  constexpr int kColGroups = CT / 4;
  constexpr int kQueryGroups = kThreads / kColGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [kChunk][CT]
  float* v_s = w_s + kChunk * CT;                // [qblock][kVStride]
  int* key_s = reinterpret_cast<int*>(v_s + qblock * kVStride);  // [S*seg]
  int* row_s = key_s + s * seg;                  // [qblock][k]
  __shared__ unsigned tap_mask;

  const int blk = blockIdx.x;
  const int col0 = blockIdx.y * CT;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = blk * qblock;
  const int table = s * seg;
  const int* sids = seg_ids + (b * nqb + blk) * s;
  const int* kb = keys + b * npad;

  if (tid == 0) tap_mask = 0u;
  for (int t = tid; t < table; t += kThreads)
    key_s[t] = kb[(long long)sids[t / seg] * seg + t % seg];
  __syncthreads();

  unsigned found = 0u;
  for (int e = tid; e < qblock * k; e += kThreads) {
    const int qi = e / k, kk = e % k;
    int row = -1;
    const int key =
        q0 + qi < q ? qkeys[(b * q + q0 + qi) * k + kk] : -1;
    if (key >= 0) {
      for (int si = 0; si < s; ++si) {
        const int* sk = key_s + si * seg;
        if (key < sk[0] || key > sk[seg - 1]) continue;
        int lo = 0, hi = seg - 1;  // first position with sk[pos] >= key
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sk[mid] < key) lo = mid + 1; else hi = mid;
        }
        if (sk[lo] == key) {
          row = sids[si] * seg + lo;
          break;
        }
      }
    }
    row_s[e] = row;
    if (row >= 0) found |= 1u << kk;
  }
  if (found) atomicOr(&tap_mask, found);
  __syncthreads();
  const unsigned taps = tap_mask;

  const int cg = tid % kColGroups, qg = tid / kColGroups;
  float acc[RQ][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* vb = values + b * v * cin;
  for (int kk = 0; kk < k; ++kk) {
    if (!((taps >> kk) & 1u)) continue;
    const float* wk = w + (long long)kk * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += kChunk) {
      for (int e = tid; e < qblock * kChunk; e += kThreads) {
        const int qi = e / kChunk, c = e % kChunk;
        const int row = row_s[qi * k + kk];
        float x = 0.f;
        if (row >= 0 && c0 + c < cin) {
          x = vb[(long long)row * cin + c0 + c];
          if (round_bf16) x = to_bf16(x);
        }
        v_s[qi * kVStride + c] = x;
      }
      for (int e = tid; e < kChunk * CT; e += kThreads) {
        const int c = e / CT, j = e % CT;
        float x = 0.f;
        if (c0 + c < cin && col0 + j < cout) {
          x = wk[(long long)(c0 + c) * cout + col0 + j];
          if (round_bf16) x = to_bf16(x);
        }
        w_s[c * CT + j] = x;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w_s + c * CT + cg * 4);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float x = v_s[(qg + i * kQueryGroups) * kVStride + c];
          acc[i][0] = fmaf(x, wv.x, acc[i][0]);
          acc[i][1] = fmaf(x, wv.y, acc[i][1]);
          acc[i][2] = fmaf(x, wv.z, acc[i][2]);
          acc[i][3] = fmaf(x, wv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + qg + i * kQueryGroups;
    if (qi >= q) continue;
    float* dst = out + (b * q + qi) * cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = col0 + cg * 4 + j;
      if (co < cout) dst[co] = acc[i][j];
    }
  }
}

template <int CT, int RQ>
cudaError_t launch(dim3 grid, size_t shared, cudaStream_t stream,
                   const float* values, const int* keys, const int* qkeys,
                   const int* seg_ids, const float* w, float* out, int v,
                   int npad, int q, int k, int cin, int cout, int nqb, int s,
                   int seg, int qblock, int round_bf16) {
  stencil_conv_kernel<CT, RQ><<<grid, kThreads, shared, stream>>>(
      values, keys, qkeys, seg_ids, w, out, v, npad, q, k, cin, cout, nqb, s,
      seg, qblock, round_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stencil_conv_launch(const float* values, const int* keys,
                                   const int* qkeys, const int* seg_ids,
                                   const float* w, float* out, int b, int v,
                                   int npad, int q, int k, int cin, int cout,
                                   int nqb, int s, int seg, int qblock,
                                   int round_bf16, void* stream) {
  if (b == 0 || q == 0 || cout == 0) return cudaSuccess;
  const int ct = cout <= 32 ? 32 : 64;
  const int query_groups = kThreads / (ct / 4);
  if (qblock % query_groups || k > 32) return cudaErrorInvalidValue;
  const int rq = qblock / query_groups;
  const size_t shared =
      sizeof(float) * (kChunk * ct + qblock * kVStride) +
      sizeof(int) * (s * seg + qblock * k);
  if (shared > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(nqb, (cout + ct - 1) / ct, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STENCIL_LAUNCH(CT, RQ)                                               \
  return launch<CT, RQ>(grid, shared, st, values, keys, qkeys, seg_ids, w,   \
                        out, v, npad, q, k, cin, cout, nqb, s, seg, qblock,  \
                        round_bf16)
  if (ct == 32) {
    switch (rq) {
      case 1: STENCIL_LAUNCH(32, 1);
      case 2: STENCIL_LAUNCH(32, 2);
      case 4: STENCIL_LAUNCH(32, 4);
    }
  } else {
    switch (rq) {
      case 2: STENCIL_LAUNCH(64, 2);
      case 4: STENCIL_LAUNCH(64, 4);
      case 8: STENCIL_LAUNCH(64, 8);
    }
  }
#undef STENCIL_LAUNCH
  return cudaErrorInvalidValue;
}
