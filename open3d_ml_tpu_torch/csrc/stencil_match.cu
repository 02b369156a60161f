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
// one-hot [qblock, table] per tap reduced by a min on the vector unit. On
// Hopper each tap is resolved once against a sorted shared-memory copy of
// the table (stencil_taps.cuh, the same lookup as stencil_conv.cu's).
//
// Bounds on the H100: it reads the keys, tap keys and tables and writes rel
// (int32) and found (one byte) per tap; at level 0 of the ScanNet config,
// B = 1, about 10 MB, 3 us at 3.35 TB/s. It does no arithmetic to speak of,
// so it is bound by bytes; in practice by the latency of each block's
// chain: tap keys, ids, table keys from L2, then the searches.
//
// Design: one block per (query block, batch row), 256 threads, two trips
// to memory before the searches, since at the deep levels (20 blocks) the
// kernel's time is the latency of its chain.
// 1. The block's tap keys (contiguous in qkeys, four per thread) and the
//    table's S ids are read together; a block whose taps are all misses
//    writes misses and loads no table.
// 2. The S segment ids are ordered by one warp in registers (a repeated id
//    keeps its least slot) while each thread's 16-byte unit of the table's
//    keys is already on its way (the first trip fetched the id of its
//    slot), and the unit is stored at its sorted place: one sorted array
//    (the keys of a batch row ascend, which the wrapper states as the
//    precondition). seg = 64, the ScanNet config's, is a template, so the
//    copy and the map back need no division.
// 3. Each thread resolves four taps at a time, their binary searches over
//    the whole table interleaved, maps a match back to slot * seg + row
//    (the least position, where pad keys repeat) and writes rel and found.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "stencil_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // taps per thread per round

template <int SEG>
__global__ void __launch_bounds__(kThreads)
    stencil_match_kernel(const int* __restrict__ keys,
                         const int* __restrict__ qkeys,
                         const int* __restrict__ seg_ids,
                         int* __restrict__ rel,
                         unsigned char* __restrict__ found, int npad, int q,
                         int k, int nqb, int s, int seg_rt, int qblock,
                         int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seg = SEG ? SEG : seg_rt;
  const int blk = blockIdx.x;
  const long long b = blockIdx.y;
  const int q0 = blk * qblock;
  const int taps = min(qblock, q - q0) * k;
  const long long base = (b * q + q0) * k;
  const int* qk = qkeys + base;

  // the first round of tap keys and the table's ids, loaded together
  int key[kPer], pos[kPer];
  bool live = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = i * kThreads + threadIdx.x;
    key[i] = e < taps ? qk[e] : -1;
    live |= key[i] >= 0;
  }
  const stencil::Table t = stencil::table_at(smem, s, seg);
  const int* sids = seg_ids + (b * nqb + blk) * s;
  const int* keys_b = keys + b * npad;
  const int sid = threadIdx.x < s ? sids[threadIdx.x] : 0;
  // the common case: S <= 32 and one 16-byte unit of keys per thread at
  // most; each thread also fetches the id of its unit's slot now, so that
  // the keys' load starts before the slots are ordered
  const int per = seg / 4;
  const bool early = vec && s <= 32 && s * per <= kThreads;
  const int tid = threadIdx.x;
  const int uslot = early && tid < s * per ? tid / per : -1;
  const int usid = uslot >= 0 ? sids[uslot] : 0;
  for (int e = kPer * kThreads + threadIdx.x; e < taps; e += kThreads)
    live |= qk[e] >= 0;
  if (!__syncthreads_or(live)) {
    for (int e = threadIdx.x; e < taps; e += kThreads) {
      rel[base + e] = stencil::kBigPos;
      found[base + e] = 0;
    }
    return;
  }
  if (early) {
    int* rank_of = t.count + 1;  // [S]
    int4 unit;
    const int c = (tid - uslot * per) * 4;
    if (uslot >= 0)
      unit = *reinterpret_cast<const int4*>(keys_b + (long long)usid * seg + c);
    if (threadIdx.x < 32) stencil::order_slots_warp(t, sid, s, rank_of);
    __syncthreads();
    if (uslot >= 0 && rank_of[uslot] >= 0)
      *reinterpret_cast<int4*>(t.key_s + rank_of[uslot] * seg + c) = unit;
  } else {
    if (s <= 32) {
      if (threadIdx.x < 32) stencil::order_slots_warp(t, sid, s);
      __syncthreads();
    } else {
      if (threadIdx.x < s) t.sid_s[threadIdx.x] = sid;
      for (int i = kThreads + threadIdx.x; i < s; i += kThreads)
        t.sid_s[i] = sids[i];
      __syncthreads();
      stencil::order_tables([&](int) { return t; }, 1, 1u, s);
    }
    const int units = s * (vec ? per : seg);
    for (int u = threadIdx.x; u < units; u += kThreads)
      stencil::copy_keys<SEG>(t, keys_b, u, seg, vec);
  }
  __syncthreads();
  const int n = *t.count * seg;
  for (int e0 = 0; e0 < taps; e0 += kPer * kThreads) {
    if (e0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = e0 + i * kThreads + threadIdx.x;
        key[i] = e < taps ? qk[e] : -1;
      }
    }
    stencil::lower_bounds<kPer>(t.key_s, n, key, pos);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = e0 + i * kThreads + threadIdx.x;
      if (e >= taps) continue;
      const bool hit = stencil::matched(t.key_s, n, pos[i], key[i]);
      rel[base + e] = hit ? stencil::table_pos<SEG>(t, pos[i], key[i], seg)
                          : stencil::kBigPos;
      found[base + e] = hit;
    }
  }
}

template <int SEG>
cudaError_t launch(dim3 grid, size_t shared, cudaStream_t stream,
                   const int* keys, const int* qkeys, const int* seg_ids,
                   int* rel, unsigned char* found, int npad, int q, int k,
                   int nqb, int s, int seg, int qblock, int vec) {
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_match_kernel<SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  stencil_match_kernel<SEG><<<grid, kThreads, shared, stream>>>(
      keys, qkeys, seg_ids, rel, found, npad, q, k, nqb, s, seg, qblock, vec);
  return cudaGetLastError();
}

// the kernel's dynamic shared memory: its sorted table and the sorted place
// of each slot
constexpr size_t match_shared(int s, int seg) {
  return stencil::table_bytes(s, seg) + sizeof(int) * (size_t)s;
}

}  // namespace

// The dynamic shared memory in bytes of a launch at (s, seg), INT_MAX past
// what an int holds: the size the wrapper passes as `shared`.
extern "C" int stencil_match_shared(int s, int seg) {
  const size_t bytes = match_shared(s, seg);
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

extern "C" int stencil_match_launch(const int* keys, const int* qkeys,
                                    const int* seg_ids, int* rel,
                                    unsigned char* found, int b, int npad,
                                    int q, int k, int nqb, int s, int seg,
                                    int qblock, int shared, void* stream) {
  if (b == 0 || q == 0 || k == 0) return cudaSuccess;
  if ((size_t)shared < match_shared(s, seg) ||
      (long long)(nqb - 1) * qblock >= q || b > 65535)
    return cudaErrorInvalidValue;
  const int vec = seg % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const dim3 grid(nqb, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seg == 64)
    return launch<64>(grid, shared, st, keys, qkeys, seg_ids, rel, found,
                      npad, q, k, nqb, s, seg, qblock, vec);
  return launch<0>(grid, shared, st, keys, qkeys, seg_ids, rel, found, npad,
                   q, k, nqb, s, seg, qblock, vec);
}
