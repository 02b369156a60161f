// Stencil rulebook: the table position of each tap of SparseConvUnet's
// submanifold, down and up convolutions, by Morton-key equality.
//
// Replaces the TPU kernel in open3d_ml_tpu/ops/pallas/stencil.py,
// stencil_match_pallas: _match_kernel, which the stencil convolution's
// backward runs. Contract, as stencil_match_plain in
// open3d_ml_tpu_torch/ops/cuda/stencil.py states it:
//
//   rel[b, i, k]   = the least position p of block i / qblock's table with
//                    key(p) == qkeys[b, i, k], or 0x7F000000 where none;
//   found[b, i, k] = whether such a position exists.
//
// On the TPU the kernel compared every tap key with every table key, a
// one-hot [qblock, table] per tap reduced by a min on the vector unit, and
// wrote each tap's column by a broadcast select. On Hopper each tap is
// resolved once against a shared-memory copy of the table's keys by a
// range check and a binary search per segment (stencil_taps.cuh, the same
// lookup as stencil_conv.cu's first step), and written directly.
//
// Bounds on the H100: it reads the keys, tap keys and tables and writes
// rel (int32) and found (one byte) per tap; at level 0 of the ScanNet
// config, B = 1, about 10 MB, 3 us at 3.35 TB/s. It does no arithmetic to
// speak of, so it is bound by bytes. Each block reads its table's keys
// (at most 4 KB) from device memory once, so neighbouring blocks whose
// tables share segments read them again, from L2 where they still are.
//
// Design: one block per (query block, batch row), 256 threads: the table's
// keys to shared memory, then one tap per thread, strided over the block's
// qblock * K taps, which lie contiguous in qkeys, rel and found.

#include <cuda_runtime.h>

#include "stencil_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBigPos = 0x7F000000;  // a miss: past any table position

__global__ void __launch_bounds__(kThreads)
    stencil_match_kernel(const int* __restrict__ keys,
                         const int* __restrict__ qkeys,
                         const int* __restrict__ seg_ids,
                         int* __restrict__ rel,
                         unsigned char* __restrict__ found, int npad, int q,
                         int k, int nqb, int s, int seg, int qblock) {
  extern __shared__ int key_s[];  // [S * seg]
  const int blk = blockIdx.x;
  const long long b = blockIdx.y;
  stencil::load_table(key_s, keys + b * npad, seg_ids + (b * nqb + blk) * s,
                      s, seg);
  __syncthreads();
  const int q0 = blk * qblock;
  const int taps = min(qblock, q - q0) * k;
  const long long base = (b * q + q0) * k;
  for (int e = threadIdx.x; e < taps; e += kThreads) {
    const int pos = stencil::find_tap(key_s, s, seg, qkeys[base + e]);
    rel[base + e] = pos >= 0 ? pos : kBigPos;
    found[base + e] = pos >= 0;
  }
}

}  // namespace

extern "C" int stencil_match_launch(const int* keys, const int* qkeys,
                                    const int* seg_ids, int* rel,
                                    unsigned char* found, int b, int npad,
                                    int q, int k, int nqb, int s, int seg,
                                    int qblock, void* stream) {
  if (b == 0 || q == 0 || k == 0) return cudaSuccess;
  const size_t shared = sizeof(int) * s * seg;
  if (shared > 48 * 1024 || (long long)(nqb - 1) * qblock >= q || b > 65535)
    return cudaErrorInvalidValue;
  stencil_match_kernel<<<dim3(nqb, b), kThreads, shared,
                         static_cast<cudaStream_t>(stream)>>>(
      keys, qkeys, seg_ids, rel, found, npad, q, k, nqb, s, seg, qblock);
  return cudaGetLastError();
}
