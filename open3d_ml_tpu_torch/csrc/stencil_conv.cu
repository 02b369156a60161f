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
// float32; the sums are float32, in any order.
//
// On the TPU a row gather was slow, so the kernel built a one-hot matrix
// of key equality [K * qblock, table] and multiplied it with the table on
// the matrix unit. On Hopper an indexed load is cheap, so this kernel
// resolves each tap's row (stencil_taps.cuh: one binary search of the
// block's table, sorted in shared memory) and reads that row.
//
// What bounds it on the H100: the products of the found taps are about 1
// GFLOP at the heaviest checked shape, 1 us at the bf16 tensor-core rate,
// and the bytes each input and output must move are a few MB (level 0 of
// the ScanNet config: about 15 MB, 4.5 us at 3.35 TB/s). What the kernel
// moves is more, all through L2: each found tap reads its value row again
// (the level-0 values, 40,000 x 64 x 4 B, sit in L2), and each block reads
// the weights of its live taps. Neither rate is what sets its pace.
// clock64 stamps per phase of a block (a one-off probe, not kept) showed a
// level-0 block spending most of its cycles on the lookup's searches and,
// in the main loop, on issuing each step's copies, while the wait on them
// was small. A step cost the same at ring depths of 2 to 8, with copies
// through L1 or not, with the B fragments built per warp or once per
// block, and when a missed row was not copied at all (its A fragment
// zeroed instead: slower, the branch costs more issue than the zero fill).
// So the kernel is bound inside the SM by the issue of its copy and
// fragment instructions at the 8 warps per SM its shared memory allows;
// two resident blocks per SM where the grid has them is what helped.
//
// Two routes, picked by the wrapper (ops/cuda/stencil.py, conv_plan):
//
// bf16 (round_bf16): an implicit GEMM on the tensor cores. One block of 4
// warps computes mw row tiles of 32 queries (a tile lies in one query
// block) by CT output channels (32 or 64); the 4 / mw warps of a row tile
// split its live taps (tap groups) and sum their tiles in shared memory at
// the end, so the deep levels, which have few row tiles, still give the
// card enough blocks, and the wide levels share each weight tile among mw
// row tiles. mma.sync.m16n8k16 (bf16 in, float32 sums) and not wgmma: a
// row tile of 32 gathered rows fits its 16-row fragments, while wgmma's
// 64-row warpgroup tiles and shared-memory descriptors would fit a query
// block of 32 awkwardly, and the products are not what bounds the kernel.
// 1. Lookup of every row tile at once, in two trips to memory: the tap
//    keys and the tables' ids by cp.async; then, once one warp per table
//    has ordered its ids (stencil_taps.cuh), every 16-byte unit of the
//    tables' keys by cp.async straight to its sorted place, all in flight
//    together. A table that no live row tile reads is not loaded. Each
//    tap is one binary search of its tile's table, with no divide per tap
//    (steps of the tap index and a shift for a power-of-two seg); its
//    value row (or -1) goes to shared memory, with a mask of the rows that
//    found each tap. A block whose taps are all misses writes zeros and
//    exits.
// 2. Main loop over (live tap, chunk of 32 input channels): a ring of 2 or
//    3 stages of cp.async copies. Each warp gathers its tile's 32 value
//    rows (a miss takes the zero-fill form, source size 0, and reads no
//    device memory; the up convolution's one live tap per query so costs
//    one row per query; a tile that found no row for the tap copies
//    nothing), the warps of a tap group copy its weight tile, and the next
//    stages load while this one's products run. The block rounds each
//    weight tile to bf16 once, into a [n][k] tile that ldmatrix reads as B
//    fragments; the A fragments are rounded to bf16 (to nearest even) as
//    they are built from the float32 rows. A 16-row half of a tile that
//    found no row for the tap skips its products.
//
// float32: the products stay on the CUDA cores in float32 FMA (never
// tensor cores or TF32): the card-vs-CPU float32 gates at 1e-4 and the
// float32 backward's bit-equality rely on true float32 products. One block
// per (query block, tile of CT output channels, batch row), 256 threads:
// the block's table sorted by load_table (stencil_taps.cuh), one search
// per tap, then for each live tap and each chunk of 32 input
// channels the matched rows and the weight tile go to shared memory, and
// each thread accumulates an RQ x 4 tile of outputs in registers.
//
// Both routes take their shared memory from the wrapper (conv_plan), which
// asks stencil_conv_shared, the one formula of the layout, for its size;
// past 48 KB the launch opts in, up to the H100's 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "stencil_taps.cuh"

namespace {

constexpr int kRows = 32;  // queries per row tile
constexpr int kKC = 32;    // input channels per step
constexpr int kMaxTaps = 32;

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kVStride = kKC + 1;  // padded row: no bank conflicts

__host__ __device__ constexpr size_t fma_shared(int ct, int qblock, int k,
                                                int s, int seg) {
  return sizeof(float) * ((size_t)kKC * ct + (size_t)qblock * kVStride) +
         sizeof(int) * ((size_t)qblock * k + 4) + stencil::table_bytes(s, seg);
}

template <int CT, int RQ>
__global__ void __launch_bounds__(kThreads)
    stencil_conv_fma_kernel(const float* __restrict__ values,
                            const int* __restrict__ keys,
                            const int* __restrict__ qkeys,
                            const int* __restrict__ seg_ids,
                            const float* __restrict__ w,
                            float* __restrict__ out, int v, int npad, int q,
                            int k, int cin, int cout, int nqb, int s, int seg,
                            int qblock, int vec_keys) {
  constexpr int kColGroups = CT / 4;
  constexpr int kQueryGroups = kThreads / kColGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  // 16-byte aligned: w_s for float4 reads, the table (qblock a multiple of
  // 4) for its 16-byte copy
  float* w_s = reinterpret_cast<float*>(smem);  // [kKC][CT]
  float* v_s = w_s + kKC * CT;                  // [qblock][kVStride]
  const stencil::Table t =
      stencil::table_at(v_s + qblock * kVStride, s, seg);
  int* row_s = t.count + 1;  // [qblock][k]
  unsigned* tap_mask = reinterpret_cast<unsigned*>(row_s + qblock * k);

  const int blk = blockIdx.x;
  const int col0 = blockIdx.y * CT;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = blk * qblock;

  if (tid == 0) *tap_mask = 0u;
  stencil::load_table<0>(t, keys + b * npad, seg_ids + (b * nqb + blk) * s, s,
                         seg, vec_keys);
  const int n = *t.count * seg;
  unsigned found = 0u;
  for (int e = tid; e < qblock * k; e += kThreads) {
    const int qi = e / k, kk = e - qi * k;
    int key[1] = {q0 + qi < q ? qkeys[(b * q + q0 + qi) * k + kk] : -1};
    int pos[1];
    stencil::lower_bounds<1>(t.key_s, n, key, pos);
    int row = -1;
    if (stencil::matched(t.key_s, n, pos[0], key[0])) {
      row = stencil::value_row<0>(t, pos[0], seg);
      if (row >= v) row = -1;  // a pad row: no value (never on the path)
    }
    row_s[e] = row;
    if (row >= 0) found |= 1u << kk;
  }
  if (found) atomicOr(tap_mask, found);
  __syncthreads();
  const unsigned taps = *tap_mask;

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
    for (int c0 = 0; c0 < cin; c0 += kKC) {
      for (int e = tid; e < qblock * kKC; e += kThreads) {
        const int qi = e / kKC, c = e % kKC;
        const int row = row_s[qi * k + kk];
        v_s[qi * kVStride + c] =
            row >= 0 && c0 + c < cin ? vb[(long long)row * cin + c0 + c] : 0.f;
      }
      for (int e = tid; e < kKC * CT; e += kThreads) {
        const int c = e / CT, j = e % CT;
        w_s[c * CT + j] = c0 + c < cin && col0 + j < cout
                              ? wk[(long long)(c0 + c) * cout + col0 + j]
                              : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kKC; ++c) {
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

// ----------------------------------------------------------------- bf16

constexpr int kWarps = 4;
constexpr int kMmaThreads = kWarps * 32;
constexpr int kMaxStages = 3;  // ring stages: 2 or 3, by conv_plan
constexpr int kAStride = kKC + 8;  // floats; = 8 mod 32: float2 reads of
                                   // a half-warp hit distinct banks

__host__ __device__ constexpr int b_stride(int ct) { return ct + 4; }

// words per row of the bf16 weight tile [CT][kKC / 2 pairs], padded so
// that ldmatrix's 8 rows of 16 bytes hit distinct banks
constexpr int kBtRow = kKC / 2 + 4;

__host__ __device__ constexpr size_t bt_bytes(int ct, int mw) {
  return sizeof(unsigned) * (kWarps / mw) * ct * kBtRow;
}

// floats of one ring stage: the 4 warps' row tiles, the tap groups' weights
__host__ __device__ constexpr size_t stage_floats(int ct, int mw) {
  return (size_t)kWarps * kRows * kAStride +
         (size_t)(kWarps / mw) * kKC * b_stride(ct);
}

// row_s [mw][k][32], rmask [mw][32], tap_list [32], live and need words
// (+2 pad)
__host__ __device__ constexpr size_t mma_header(int mw, int k) {
  return sizeof(int) * ((size_t)mw * k * kRows + (size_t)mw * kMaxTaps +
                        kMaxTaps + 4);
}

// the lookup's use of the ring: the block's tap keys, then its tables
__host__ __device__ constexpr size_t mma_lookup(int mw, int k, int s,
                                                int seg) {
  return sizeof(int) * (size_t)mw * kRows * k +
         (size_t)mw * stencil::table_stride(s, seg);
}

__host__ __device__ constexpr size_t mma_shared(int ct, int mw, int k, int s,
                                                int seg, int stages) {
  const size_t ring =
      sizeof(float) * stages * stage_floats(ct, mw) + bt_bytes(ct, mw);
  const size_t lookup = mma_lookup(mw, k, s, seg);
  return mma_header(mw, k) + (ring > lookup ? ring : lookup);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

template <bool VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool pred) {
  if (VEC)
    cp_async16(dst, src, pred);
  else
    cp_async4(dst, src, pred);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most n groups are pending, n < kMaxStages - 1
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// two floats as bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3,
                                            const unsigned* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&bb)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(bb[0]), "r"(bb[1]));
}

template <int CT, int MW, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
    stencil_conv_mma_kernel(const float* __restrict__ values,
                            const int* __restrict__ keys,
                            const int* __restrict__ qkeys,
                            const int* __restrict__ seg_ids,
                            const float* __restrict__ w,
                            float* __restrict__ out, int v, int npad, int q,
                            int k, int cin, int cout, int nqb, int s, int seg,
                            int qblock, int stages, int vec_keys) {
  constexpr int NT = CT / 8;  // n8 tiles per warp
  constexpr int BS = b_stride(CT);
  constexpr int TG = kWarps / MW;  // tap groups
  extern __shared__ __align__(16) unsigned char smem[];
  int* row_s = reinterpret_cast<int*>(smem);                   // [MW][k][32]
  unsigned* rmask = reinterpret_cast<unsigned*>(row_s + MW * k * kRows);
  int* tap_list = reinterpret_cast<int*>(rmask + MW * kMaxTaps);
  unsigned* live_s = reinterpret_cast<unsigned*>(tap_list + kMaxTaps);
  float* ring = reinterpret_cast<float*>(smem + mma_header(MW, k));
  const size_t stage = stage_floats(CT, MW);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MW * kRows;
  const int n0 = blockIdx.y * CT;
  const long long b = blockIdx.z;
  const int rows_here = min(MW * kRows, q - m0);
  const int cols_here = min(CT, cout - n0);

  for (int i = tid; i < MW * kMaxTaps; i += kMmaThreads) rmask[i] = 0u;
  if (tid == 0) live_s[0] = live_s[1] = 0u;

  // 1. lookup of every row tile at once, in two trips to memory: the
  // block's tap keys and its tables' ids, then the tables' keys. The ring
  // holds them until the main loop starts.
  int* qk_s = reinterpret_cast<int*>(ring);  // [rows_here * k]
  unsigned char* tab_base = reinterpret_cast<unsigned char*>(qk_s) +
                            sizeof(int) * MW * kRows * k;
  const size_t tstride = stencil::table_stride(s, seg);
  const int blk0 = m0 / qblock;
  const int ntab = (m0 + rows_here - 1) / qblock - blk0 + 1;
  auto table = [&](int i) {
    return stencil::table_at(tab_base + i * tstride, s, seg);
  };
  {
    const int taps = rows_here * k;
    const int* qk = qkeys + (b * q + m0) * k;
    const int n4 = reinterpret_cast<uintptr_t>(qk) % 16 == 0 ? taps / 4 : 0;
    for (int u = tid; u < n4; u += kMmaThreads)
      cp_async16(qk_s + 4 * u, qk + 4 * u, true);
    for (int e = 4 * n4 + tid; e < taps; e += kMmaThreads)
      cp_async4(qk_s + e, qk + e, true);
    for (int i = tid; i < ntab * s; i += kMmaThreads) {
      const int tb = i / s;
      cp_async4(table(tb).sid_s + (i - tb * s),
                seg_ids + (b * nqb + blk0 + tb) * s + (i - tb * s), true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    unsigned tiles = 0u;  // row tiles with a live tap of this thread
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      const int n = min(kRows, rows_here - mt * kRows) * k;
      for (int e = tid; e < n; e += kMmaThreads)
        if (qk_s[mt * kRows * k + e] >= 0) tiles |= 1u << mt;
    }
    if (tiles) atomicOr(&live_s[1], tiles);
  }
  __syncthreads();
  const unsigned tiles = live_s[1];
  unsigned need = 0u;  // the tables that live row tiles read
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
    if ((tiles >> mt) & 1u) need |= 1u << ((m0 + mt * kRows) / qblock - blk0);
  if (s <= 32) {  // warp w orders table w
    if (warp < ntab && (need >> warp) & 1u) {
      const stencil::Table t = table(warp);
      stencil::order_slots_warp(t, lane < s ? t.sid_s[lane] : 0, s);
    }
    __syncthreads();
  } else {
    stencil::order_tables(table, ntab, need, s);
  }
  {  // every unit of the needed tables' keys in flight at once
    const int per = s * (vec_keys ? seg / 4 : seg);  // copies per table
    for (int u = tid; u < ntab * per; u += kMmaThreads) {
      const int tb = u / per;
      const int* src;
      int* dst;
      if ((need >> tb) & 1u &&
          stencil::key_unit<0>(table(tb), keys + b * npad, u - tb * per, seg,
                               vec_keys, src, dst)) {
        if (vec_keys)
          cp_async16(dst, src, true);
        else
          cp_async4(dst, src, true);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  // the searches' divides by constants of the launch, taken once
  const int seg_shift = (seg & (seg - 1)) == 0 ? __ffs(seg) - 1 : -1;
  const int step_q = kMmaThreads / k, step_k = kMmaThreads - step_q * k;
#pragma unroll 1
  for (int mt = 0; mt < MW; ++mt) {
    const int r0 = mt * kRows;  // row tile's first row in the block
    const int tb = (m0 + r0) / qblock - blk0;
    if (!((tiles >> mt) & 1u)) continue;
    const stencil::Table t = table(tb);
    const int n = *t.count * seg;
    const int taps = min(kRows, rows_here - r0) * k;
    int key[8], pos[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * kMmaThreads;
      key[i] = e < taps ? qk_s[r0 * k + e] : -1;
    }
    stencil::lower_bounds<8>(t.key_s, n, key, pos);
    int qi = tid / k, kk = tid - qi * k;  // of e, stepped without a divide
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (tid + i * kMmaThreads < kRows * k) {
        int row = -1;
        if (stencil::matched(t.key_s, n, pos[i], key[i])) {
          row = stencil::value_row<0>(t, pos[i], seg, seg_shift);
          if (row >= v) row = -1;  // a pad row: no value (never on the path)
        }
        row_s[(mt * k + kk) * kRows + qi] = row;
        if (row >= 0) atomicOr(&rmask[mt * kMaxTaps + kk], 1u << qi);
      }
      qi += step_q;
      kk += step_k;
      if (kk >= k) kk -= k, ++qi;
    }
  }
  __syncthreads();
  if (tid < k) {
    unsigned any = 0u;
    for (int mt = 0; mt < MW; ++mt) any |= rmask[mt * kMaxTaps + tid];
    if (any) atomicOr(&live_s[0], 1u << tid);
  }
  __syncthreads();
  const unsigned live = live_s[0];
  if (tid < k && ((live >> tid) & 1u))
    tap_list[__popc(live & ((1u << tid) - 1u))] = tid;

  if (!live) {  // every tap a miss: zero rows (out is torch.empty)
    for (int e = tid; e < rows_here * cols_here; e += kMmaThreads) {
      const int r = e / cols_here, c = e - r * cols_here;
      out[(b * q + m0 + r) * cout + n0 + c] = 0.f;
    }
    return;
  }
  __syncthreads();  // tap_list written, the table's use of the ring over

  // 2. main loop over (tap slot, input chunk); warp (wm, wg) takes the
  // tap slot's wg-th live tap on row tile wm
  const int nlive = __popc(live);
  const int nchunk = (cin + kKC - 1) / kKC;
  const int iters = (nlive + TG - 1) / TG * nchunk;
  const int wm = warp % MW, wg = warp / MW;
  const float* vb = values + b * v * cin;

  // Each warp gathers its own tile's rows; the MW warps of a tap group
  // copy the group's weight tile. Every index below but the tap and the
  // chunk is fixed at compile time.
  constexpr int kW = VEC ? 4 : 1;    // floats per copy
  constexpr int kAU = kKC / kW;      // copies per gathered row
  constexpr int kBU = CT / kW;       // copies per weight row
  auto issue = [&](int it) {
    if (it < iters) {
      float* as = ring + (it % stages) * stage;
      const int ts = it / nchunk, c0 = (it - ts * nchunk) * kKC;
      const int j = ts * TG + wg;
      if (j < nlive) {
        const int tap = tap_list[j];
        if (rmask[wm * kMaxTaps + tap]) {  // else the tile found no row
          const int* rows = row_s + (wm * k + tap) * kRows;
          float* a = as + warp * kRows * kAStride;
#pragma unroll
          for (int i = 0; i < kRows * kAU / 32; ++i) {
            const int u = lane + 32 * i;
            const int r = u / kAU, c = u % kAU * kW;
            const int row = rows[r];
            const bool ok = row >= 0 && c0 + c < cin;
            copy_async<VEC>(a + r * kAStride + c,
                            ok ? vb + (long long)row * cin + c0 + c : values,
                            ok);
          }
        }
        float* bs = as + kWarps * kRows * kAStride + wg * kKC * BS;
        const float* wt = w + ((long long)tap * cin + c0) * cout + n0;
#pragma unroll
        for (int i = 0; i < kKC * kBU / 32 / MW; ++i) {
          const int u = lane + 32 * (i * MW + wm);
          const int r = u / kBU, col = u % kBU * kW;
          const bool ok = c0 + r < cin && n0 + col < cout;
          copy_async<VEC>(bs + r * BS + col,
                          ok ? wt + (long long)r * cout + col : w, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mh = 0; mh < 2; ++mh)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mh][nt][i] = 0.f;

  // The weight tiles of the step, rounded to bf16 once per block and laid
  // out [n][k] (pairs of k in one word, rows padded to kBtRow words) for
  // ldmatrix: the warps of a tap group share one conversion.
  unsigned* bt = reinterpret_cast<unsigned*>(ring + stages * stage);
  constexpr int kBtUnits = kKC / 2 * CT / 4;  // per tap group
  for (int it = 0; it < stages - 1; ++it) issue(it);
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int it = 0; it < iters; ++it) {
    cp_async_wait_n(stages - 2);
    __syncthreads();
    issue(it + stages - 1);
    const int ts = it / nchunk, c0 = (it - ts * nchunk) * kKC;
    const float* bs0 = ring + (it % stages) * stage + kWarps * kRows * kAStride;
#pragma unroll
    for (int i = 0; i < TG * kBtUnits / kMmaThreads; ++i) {
      const int u = tid + i * kMmaThreads;
      const int g = u / kBtUnits, e = u - g * kBtUnits;
      if (ts * TG + g >= nlive) continue;
      const int kp = e % (kKC / 2), n = e / (kKC / 2) * 4;
      const float* src = bs0 + (g * kKC + 2 * kp) * BS + n;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + BS);
      unsigned* dst = bt + (g * CT + n) * kBtRow + kp;
      dst[0] = pack_bf16(lo.x, hi.x);
      dst[kBtRow] = pack_bf16(lo.y, hi.y);
      dst[2 * kBtRow] = pack_bf16(lo.z, hi.z);
      dst[3 * kBtRow] = pack_bf16(lo.w, hi.w);
    }
    __syncthreads();
    const int j = ts * TG + wg;
    if (j >= nlive) continue;
    const unsigned mask = rmask[wm * kMaxTaps + tap_list[j]];
    if (!mask) continue;
    const float* as = ring + (it % stages) * stage + warp * kRows * kAStride;
    // this lane's row address for ldmatrix.x4: matrix lane / 8 is n-tile
    // (lane >> 4) of the pair, k half (lane >> 3) & 1
    const unsigned* bl = bt + (wg * CT + (lane >> 4) * 8 + (lane & 7)) *
                                  kBtRow + ((lane >> 3) & 1) * 4;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if (c0 + ks * 16 >= cin) break;
      unsigned bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
        ldmatrix_x4(bf[nt][0], bf[nt][1], bf[nt + 1][0], bf[nt + 1][1],
                    bl + nt * 8 * kBtRow + ks * 8);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
        if (!((mask >> (mh * 16)) & 0xFFFFu)) continue;
        const float* p = as + (mh * 16 + g8) * kAStride + ks * 16 + 2 * t4;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * kAStride);
        const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
        const float2 x3 =
            *reinterpret_cast<const float2*>(p + 8 * kAStride + 8);
        const unsigned af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mh][nt], af, bf[nt]);
      }
    }
  }
  cp_async_wait<0>();

  // 3. the tap groups of a row tile sum their tiles; group 0 stores
  if (TG > 1) {
    __syncthreads();  // every warp done with the ring
    float* red = ring;  // [kWarps][CT][32], lane-minor: no bank conflicts
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(warp * CT + (mh * NT + nt) * 4 + i) * 32 + lane] =
              acc[mh][nt][i];
    __syncthreads();
    if (wg != 0) return;
    for (int g = 1; g < TG; ++g) {
      const int src = wm + g * MW;
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mh][nt][i] +=
                red[(src * CT + (mh * NT + nt) * 4 + i) * 32 + lane];
    }
  }
  const bool pairs = (cout & 1) == 0;
#pragma unroll
  for (int mh = 0; mh < 2; ++mh)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * kRows + mh * 16 + h * 8 + g8;
      if (r >= q) continue;
      float* dst = out + (b * q + r) * cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + nt * 8 + 2 * t4;
        const float x = acc[mh][nt][2 * h], y = acc[mh][nt][2 * h + 1];
        if (pairs && col + 1 < cout) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(x, y);
        } else {
          if (col < cout) dst[col] = x;
          if (col + 1 < cout) dst[col + 1] = y;
        }
      }
    }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t shared) {
  if (shared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
}

struct Args {
  const float* values;
  const int* keys;
  const int* qkeys;
  const int* seg_ids;
  const float* w;
  float* out;
  int v, npad, q, k, cin, cout, nqb, s, seg, qblock;
};

template <int CT, int RQ>
cudaError_t launch_fma(dim3 grid, size_t shared, cudaStream_t stream,
                       const Args& a, int vec_keys) {
  const cudaError_t err = opt_in(stencil_conv_fma_kernel<CT, RQ>, shared);
  if (err != cudaSuccess) return err;
  stencil_conv_fma_kernel<CT, RQ><<<grid, kThreads, shared, stream>>>(
      a.values, a.keys, a.qkeys, a.seg_ids, a.w, a.out, a.v, a.npad, a.q,
      a.k, a.cin, a.cout, a.nqb, a.s, a.seg, a.qblock, vec_keys);
  return cudaGetLastError();
}

template <int CT, int MW, bool VEC>
cudaError_t launch_mma(dim3 grid, size_t shared, cudaStream_t stream,
                       const Args& a, int stages, int vec_keys) {
  const cudaError_t err =
      opt_in(stencil_conv_mma_kernel<CT, MW, VEC>, shared);
  if (err != cudaSuccess) return err;
  stencil_conv_mma_kernel<CT, MW, VEC>
      <<<grid, kMmaThreads, shared, stream>>>(
          a.values, a.keys, a.qkeys, a.seg_ids, a.w, a.out, a.v, a.npad, a.q,
          a.k, a.cin, a.cout, a.nqb, a.s, a.seg, a.qblock, stages,
          vec_keys);
  return cudaGetLastError();
}

template <int CT, bool VEC>
cudaError_t launch_mma(dim3 grid, size_t shared, cudaStream_t stream,
                       const Args& a, int mw, int stages, int vec_keys) {
  switch (mw) {
    case 1:
      return launch_mma<CT, 1, VEC>(grid, shared, stream, a, stages,
                                    vec_keys);
    case 2:
      return launch_mma<CT, 2, VEC>(grid, shared, stream, a, stages,
                                    vec_keys);
    case 4:
      return launch_mma<CT, 4, VEC>(grid, shared, stream, a, stages,
                                    vec_keys);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The dynamic shared memory in bytes of a launch with this plan (route 1:
// ct, mw row tiles and a ring of `stages`; route 0: ct and qblock), -1 for
// a plan the kernels do not have, INT_MAX past what an int holds.
extern "C" int stencil_conv_shared(int route, int ct, int mw, int stages,
                                   int qblock, int k, int s, int seg) {
  size_t bytes;
  if (route == 1 && (mw == 1 || mw == 2 || mw == 4))
    bytes = mma_shared(ct, mw, k, s, seg, stages);
  else if (route == 0)
    bytes = fma_shared(ct, qblock, k, s, seg);
  else
    return -1;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// route 1: the bf16 tensor-core kernel (round_bf16), route 0: the float32
// FMA kernel; ct output channels per block; mw row tiles per block and
// stages of its ring (route 1); shared: the dynamic shared memory in
// bytes, stencil_conv_shared of the plan or more.
extern "C" int stencil_conv_launch(const float* values, const int* keys,
                                   const int* qkeys, const int* seg_ids,
                                   const float* w, float* out, int b, int v,
                                   int npad, int q, int k, int cin, int cout,
                                   int nqb, int s, int seg, int qblock,
                                   int route, int ct, int mw, int stages,
                                   int shared, void* stream) {
  if (b == 0 || q == 0 || cout == 0) return cudaSuccess;
  if (k > kMaxTaps || b > 65535 || (ct != 32 && ct != 64) ||
      (long long)(nqb - 1) * qblock >= q)
    return cudaErrorInvalidValue;
  const Args a{values, keys, qkeys, seg_ids, w, out, v, npad, q, k, cin,
               cout, nqb, s, seg, qblock};
  const int vec_keys = seg % 4 == 0 && aligned16(keys);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (cout + ct - 1) / ct;
  if (route == 1) {
    if (qblock % kRows || (mw != 1 && mw != 2 && mw != 4) || stages < 2 ||
        stages > kMaxStages ||
        (size_t)shared < mma_shared(ct, mw, k, s, seg, stages))
      return cudaErrorInvalidValue;
    const bool vec = cin % 4 == 0 && cout % 4 == 0 && aligned16(values) &&
                     aligned16(w);
    const int tiles = (q + kRows - 1) / kRows;
    const dim3 grid((tiles + mw - 1) / mw, ntiles, b);
    if (ct == 32)
      return vec ? launch_mma<32, true>(grid, shared, st, a, mw, stages,
                                        vec_keys)
                 : launch_mma<32, false>(grid, shared, st, a, mw, stages,
                                         vec_keys);
    return vec ? launch_mma<64, true>(grid, shared, st, a, mw, stages,
                                      vec_keys)
               : launch_mma<64, false>(grid, shared, st, a, mw, stages,
                                       vec_keys);
  }
  if (route != 0) return cudaErrorInvalidValue;
  const int query_groups = kThreads / (ct / 4);
  if (qblock % query_groups ||
      (size_t)shared < fma_shared(ct, qblock, k, s, seg))
    return cudaErrorInvalidValue;
  const int rq = qblock / query_groups;
  const dim3 grid(nqb, ntiles, b);
  if (ct == 32) {
    switch (rq) {
      case 1: return launch_fma<32, 1>(grid, shared, st, a, vec_keys);
      case 2: return launch_fma<32, 2>(grid, shared, st, a, vec_keys);
      case 4: return launch_fma<32, 4>(grid, shared, st, a, vec_keys);
    }
  } else {
    switch (rq) {
      case 2: return launch_fma<64, 2>(grid, shared, st, a, vec_keys);
      case 4: return launch_fma<64, 4>(grid, shared, st, a, vec_keys);
      case 8: return launch_fma<64, 8>(grid, shared, st, a, vec_keys);
    }
  }
  return cudaErrorInvalidValue;
}
