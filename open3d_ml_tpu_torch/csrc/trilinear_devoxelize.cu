// Trilinear devoxelisation: each point reads its voxel grid's features at
// its coordinates, trilinearly interpolated from the 8 cells around it;
// and the grid backward, which gives each cell the sum of the cotangents
// of the points that read it, each times the weight it read with.
//
// Replaces no pallas_call: the JAX package computes this with eight XLA
// gathers under autodiff (open3d_ml_tpu/ops/interpolation.py
// trilinear_devoxelize), where the reference has a native op pair
// (trilinear_devoxelize_forward / _backward). PVCNN's PVConv blocks run it
// once a block, after the voxel branch's 3D convolutions. Contract, as
// devoxelize_plain in open3d_ml_tpu_torch/ops/cuda/devoxelize.py states
// it, on a channels-last grid [B, r, r, r, C] and voxel-unit coordinates
// [B, N, 3]:
//
//   c = clamp(coords, 0, r - 1); lo = clamp(floor(c), 0, r - 2);
//   f = c - lo; out[b, n, :] = sum over the corners (dx, dy, dz) in the
//   order 000, 001, 010, ..., 111 of grid[b, lo + (dx, dy, dz), :] * w,
//   w = (wx * wy) * wz, wx = dx ? f.x : 1 - f.x (and so for y, z),
//
// the sum starting from 0. Every product and sum is an explicit
// __fmul_rn / __fsub_rn / __fadd_rn in that order, so no FMA contraction
// changes a bit.
//
// The plan. Both kernels read the points cell by cell: a plan per
// (coordinates, r), built once and shared by every block of one
// resolution, holds each point's lo cell (the flat b r^3 + (x r + y) r + z
// of lo), the permutation of the B N points sorted by lo cell, stable
// (ascending point index within a cell), the CSR offsets of the B r^3
// cells, and each sorted point's 8 corner weights. Built by a count pass
// (int atomics, which also give each point its arrival slot), a two-pass
// scan, a scatter to the slots and a pass that ranks each point within
// its cell by counting the smaller indices there (and writes its
// weights), so the plan is the same bits in every run. The rank pass
// costs the square of a cell's count: microseconds for the clouds PVCNN
// voxelises, about half a millisecond for 20,480 points in one cell
// (PERF.md keeps the time).
//
// The forward: the points in plan order, a warp 32 at a time. A lane
// loads its point's lo cell and computes its 8 weights once; the
// half-warps take the points two at a time through __shfl_sync, a lane a
// float4 unit of 64 channels (a second block row for C 128), loading the
// 8 corner rows at once and writing the point's contiguous row of out.
// In plan order consecutive points share corner rows, which L1 and L2
// serve with no block barrier and with the work spread evenly over the
// warps by point, however the points fill the grid.
//
// The grid backward: owner computes, no atomics. A warp owns a group of 8
// cells along z and 64 channels, a lane a float2 unit. The group's 64
// runs (cell, corner k = 0..7 in the order above: the points of lo cell
// cell - corner k, in ascending point index) are read from the plan's
// offsets; the warp walks their concatenation 16 contributions at a time:
// lane i finds the i-th (its point and the plan's weight), the warp loads
// the 16 cotangent rows at once and, while the next 16 indices load, adds
// each in turn as __fadd_rn(acc, __fmul_rn(g, w)) from +0, writing a
// cell's row (__stcs) where the next cell's contributions begin and zeros
// for a cell no point reads, so every dgrid row is written once and
// dgrid needs no zero fill. That is the order in which
// devoxelize_grad_plain's eight index_add_ calls sum on the CPU (corner
// by corner, each row's sources in ascending index), so the backward
// equals it bit for bit, on any input, in every run. A group's time is a
// few rounds of dependent loads (offsets, indices, rows), so what the
// card hides is set by the warps an SM holds: 16 rows a round keep the
// kernel within 64 registers, 4 CTAs (32 warps) an SM. A cell's sum is a
// chain as long as its contributions, so a group over a crowded cell
// takes the longest: 20,480 points in one cell give 8 chains of 20,480
// rounds' worth (PERF.md keeps the time).
//
// The staged design (a CTA a tile of cells walked along x, cp.async
// slabs of grid rows or cotangent rows in shared memory) is kept in
// variants/trilinear_devoxelize_staged.cu and measured against this one
// by `chip_smoke.py --devox-staged`: slower at every path shape and on
// the S3DIS rooms, whose points crowd a few tiles (PERF.md keeps the
// readings).
//
// Bounds on the H100: device memory. The forward reads the grid rows
// some point reads, the coordinates and the plan, and writes [B, N, C];
// the backward reads the cotangents and writes the whole dgrid (at
// PVCNN's first block, B 4, N 40,960, r 64, C 64, a 268 MB grid and 42 MB
// of points). Both kernels stand well above them: the forward reads each
// corner row through L2 once per point that reads it, the backward each
// cotangent row once per cell it reaches (8 times), in rounds of
// dependent loads. C must be a multiple of 4 and the tensors 16-byte
// aligned: the wrappers raise otherwise, so there is no scalar path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 16;        // float4 units of a block's 64 channels

// lo and f of point p, as corner_weights computes them
__device__ __forceinline__ void point_frac(const float* __restrict__ coords,
                                           long long p, int r, int lo[3],
                                           float f[3]) {
  const float top = (float)(r - 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = fminf(fmaxf(__ldg(coords + p * 3 + k), 0.f), top);
    int l = (int)floorf(c);
    l = min(l, r - 2);
    l = max(l, 0);
    lo[k] = l;
    f[k] = __fsub_rn(c, (float)l);
  }
}

__device__ __forceinline__ float axis_weight(float f, int d) {
  return d ? f : __fsub_rn(1.f, f);
}

__device__ __forceinline__ float corner_weight(const float f[3], int dx,
                                               int dy, int dz) {
  return __fmul_rn(__fmul_rn(axis_weight(f[0], dx), axis_weight(f[1], dy)),
                   axis_weight(f[2], dz));
}

__device__ __forceinline__ void madd4(float4& acc, const float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
}

__device__ __forceinline__ long long flat_cell(long long base, int r, int x,
                                               int y, int z) {
  return base + ((long long)x * r + y) * r + z;
}

// ------------------------------------------------------------------ plan

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanChunk = kScanThreads * kScanItems;

// each point's lo cell, its cell's count, and the point's arrival among
// them (in no fixed order; the rank pass fixes the order)
__global__ void __launch_bounds__(kThreads)
    devoxelize_plan_count_kernel(const float* __restrict__ coords,
                                 int* __restrict__ cell,
                                 int* __restrict__ counts,
                                 int* __restrict__ slot, int total, int n,
                                 int r) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    int lo[3];
    float f[3];
    point_frac(coords, i, r, lo, f);
    const int c =
        (int)flat_cell((long long)(i / n) * r * r * r, r, lo[0], lo[1], lo[2]);
    cell[i] = c;
    slot[i] = atomicAdd(counts + c, 1);
  }
}

// the sum of v over the block, in every thread
__device__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += scratch[w];
  return t;
}

// the sum of v over the threads before this one
__device__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  return before + incl - v;
}

__global__ void __launch_bounds__(kScanThreads)
    devoxelize_plan_sums_kernel(const int* __restrict__ counts,
                                int* __restrict__ partial, int m) {
  __shared__ int scratch[32];
  const int first = blockIdx.x * kScanChunk + threadIdx.x * kScanItems;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (first + k < m) s += counts[first + k];
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kScanThreads)
    devoxelize_plan_offsets_kernel(const int* __restrict__ counts,
                                   const int* __restrict__ partial,
                                   int* __restrict__ offsets, int m) {
  __shared__ int scratch[32];
  int pre = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += kScanThreads)
    pre += partial[i];
  pre = block_sum(pre, scratch);
  const int first = blockIdx.x * kScanChunk + threadIdx.x * kScanItems;
  int v[kScanItems], local = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = first + k < m ? counts[first + k] : 0;
    local += v[k];
  }
  int run = pre + block_exclusive_scan(local, scratch);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (first + k < m) offsets[first + k] = run;
    run += v[k];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kScanThreads - 1)
    offsets[m] = run;
}

__global__ void __launch_bounds__(kThreads)
    devoxelize_plan_scatter_kernel(const int* __restrict__ cell,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ slot,
                                   int* __restrict__ unsorted, int total) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads)
    unsorted[offsets[cell[i]] + slot[i]] = i;
}

// each point to its rank among its cell's points: the stable order; and
// its 8 corner weights, in CORNERS order, at its sorted position
__global__ void __launch_bounds__(kThreads)
    devoxelize_plan_rank_kernel(const float* __restrict__ coords,
                                const int* __restrict__ cell,
                                const int* __restrict__ offsets,
                                const int* __restrict__ unsorted,
                                int* __restrict__ perm,
                                float4* __restrict__ weights, int total,
                                int r) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const int p = unsorted[i];
    const int c = cell[p];
    const int start = offsets[c], end = offsets[c + 1];
    int rank = 0;
    for (int j = start; j < end; ++j) rank += unsorted[j] < p;
    perm[start + rank] = p;
    int lo[3];
    float f[3], w[8];
    point_frac(coords, p, r, lo, f);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      w[k] = corner_weight(f, k >> 2, (k >> 1) & 1, k & 1);
    weights[2 * (start + rank)] = make_float4(w[0], w[1], w[2], w[3]);
    weights[2 * (start + rank) + 1] = make_float4(w[4], w[5], w[6], w[7]);
  }
}

// --------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads)
    devoxelize_fwd_kernel(const float4* __restrict__ grid,
                          const float* __restrict__ coords,
                          const int* __restrict__ perm,
                          const int* __restrict__ cell,
                          float4* __restrict__ out, int total, int r,
                          int units) {
  const int cu0 = blockIdx.y * kUnits;
  const int cunits = min(kUnits, units - cu0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, u = lane & 15;
  const long long plane = (long long)r * r;
  for (int first = (blockIdx.x * kWarps + warp) * 32; first < total;
       first += gridDim.x * kWarps * 32) {
    // lane i: point first + i of the sorted order, its lo cell and weights
    int p = 0, c = 0;
    float w[8];
    if (first + lane < total) {
      p = __ldg(perm + first + lane);
      c = __ldg(cell + p);
      int lo[3];
      float f[3];
      point_frac(coords, p, r, lo, f);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = corner_weight(f, k >> 2, (k >> 1) & 1, k & 1);
    }
    // the half-warps take the points two at a time, a lane a float4
    const int count = min(32, total - first);
    for (int i = 0; i < count; i += 2) {
      const int src = i + half;
      const int pp = __shfl_sync(~0u, p, src);
      const int cc = __shfl_sync(~0u, c, src);
      float ww[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) ww[k] = __shfl_sync(~0u, w[k], src);
      if (src < count && u < cunits) {
        float4 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const long long row =
              cc + (k >> 2) * plane + ((k >> 1) & 1) * r + (k & 1);
          v[k] = __ldg(grid + row * units + cu0 + u);
        }
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 8; ++k) madd4(acc, v[k], ww[k]);
        __stcs(out + (long long)pp * units + cu0 + u, acc);
      }
    }
  }
}

// -------------------------------------------------------------- backward

constexpr int kGroup = 8;               // a group's cells along z
constexpr int kRuns = kGroup * 8;       // a group's (cell, corner) runs
constexpr int kPer = kRuns / 32;        // runs a lane sets up
constexpr int kZ = kGroup + 2;          // offsets a (dx, dy) reads along z
constexpr int kOffs = 4 * kZ;           // the CSR offsets a group reads
constexpr int kPairs = 32;              // float2 units of 64 channels
constexpr int kBatch = 16;              // contributions a warp loads at once
constexpr int kBwdBlocks = 4;           // CTAs an SM holds: 64 registers

__device__ __forceinline__ void madd2(float2& acc, const float2 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
}

// entry e of a group's offsets: for (dx, dy) = (e / 2 kZ, e / kZ % 2) the
// start of lo cell (x - dx, y - dy, z0 - 1 + e % kZ), the last entry of
// each the end of the cell before it; 0 where the cell lies outside
__device__ __forceinline__ int group_offset(const int* __restrict__ offsets,
                                            long long base, int r, int x,
                                            int y, int z0, int e) {
  const int sx = x - e / (2 * kZ), sy = y - (e / kZ) % 2,
            sz = z0 - 1 + e % kZ;
  return sx >= 0 && sy >= 0 && sz >= 0 && sz <= r
             ? __ldg(offsets + flat_cell(base, r, sx, sy, sz))
             : 0;
}

__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    devoxelize_bwd_kernel(const float2* __restrict__ g,
                          const int* __restrict__ perm,
                          const int* __restrict__ offsets,
                          const float* __restrict__ weights,
                          float2* __restrict__ dgrid, int r, int pairs,
                          int chunks) {
  // each warp's group: its offsets, the start of each (cell, corner) run
  // and the exclusive prefix of their lengths, the total last
  __shared__ int group_offs[kWarps][kOffs];
  __shared__ int run_start[kWarps][kRuns];
  __shared__ int run_pre[kWarps][kRuns + 1];
  const int ztiles = (r + kGroup - 1) / kGroup;
  const int ytiles = (r + kWarps - 1) / kWarps;
  int t = blockIdx.x;
  const int z0 = (t % ztiles) * kGroup;
  t /= ztiles;
  const int y0 = (t % ytiles) * kWarps;
  const int x = t / ytiles;
  const long long base = (long long)(blockIdx.y / chunks) * r * r * r;
  const int cp0 = (blockIdx.y % chunks) * kPairs;
  // a warp's group: the cells (x, y, z0..z0 + kGroup - 1); a lane a
  // float2 unit of the block's channels
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = y0 + warp;
  const bool mine = cp0 + lane < pairs;
  if (y >= r) return;  // the group lies outside the grid
  int* offs = group_offs[warp];
  int* starts = run_start[warp];
  int* pre = run_pre[warp];
  for (int e = lane; e < kOffs; e += 32)
    offs[e] = group_offset(offsets, base, r, x, y, z0, e);
  __syncwarp();
  // lane: the runs kPer lane .. kPer lane + kPer - 1
  int len[kPer], sum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = kPer * lane + q, o = idx / 8, k = idx % 8;
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int e = kZ * (k >> 1) + o - dz + 1;
    const bool inside =
        z0 + o < r && x - dx >= 0 && y - dy >= 0 && z0 + o - dz >= 0;
    starts[idx] = inside ? offs[e] : 0;
    len[q] = inside ? offs[e + 1] - offs[e] : 0;
    sum += len[q];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - sum;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    pre[kPer * lane + q] = run;
    run += len[q];
  }
  const int total = __shfl_sync(~0u, incl, 31);
  if (lane == 31) pre[kRuns] = total;
  __syncwarp();
  const long long row0 = flat_cell(base, r, x, y, z0) * pairs + cp0 + lane;
  // a cell that no point reads gets its zeros here; the rows stream past
  // L2 (evict first)
  for (int i = 0; i < kGroup; ++i)
    if (z0 + i < r && pre[8 * i + 8] == pre[8 * i] && mine)
      __stcs(dgrid + row0 + (long long)i * pairs, make_float2(0.f, 0.f));

  // The group's contributions in order (cell, then corner, then point),
  // kBatch at a time: lane i finds the i-th (its cell, point and weight); the
  // warp loads the batch's cotangent rows at once and, while the next
  // batch's indices load, adds them in turn, writing a cell's row where
  // the next cell's contributions begin.
  auto fetch = [&](int first, int& cell, int& p, float& w) {
    cell = -1;
    p = 0;
    w = 0.f;
    const int idx = first + lane;
    if (lane < kBatch && idx < total) {
      int at = 0;
#pragma unroll
      for (int step = kRuns / 2; step; step >>= 1)
        if (pre[at + step] <= idx) at += step;
      const int j = starts[at] + idx - pre[at];
      cell = at >> 3;
      p = __ldg(perm + j);
      w = __ldg(weights + 8LL * j + (at & 7));
    }
  };
  int cell, p;
  float w;
  fetch(0, cell, p, w);
  float2 acc = make_float2(0.f, 0.f);
  int cur = -1;
  for (int first = 0; first < total; first += kBatch) {
    const int n = min(kBatch, total - first);
    float2 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int pi = __shfl_sync(~0u, p, i);
      if (i < n && mine) v[i] = __ldg(g + (long long)pi * pairs + cp0 + lane);
    }
    // the batch's items that begin a cell's contributions
    const int before = __shfl_up_sync(~0u, cell, 1);
    const unsigned begins = __ballot_sync(
        ~0u, lane < n && cell != (lane == 0 ? cur : before));
    int next_cell, next_p;
    float next_w;
    fetch(first + kBatch, next_cell, next_p, next_w);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const float wi = __shfl_sync(~0u, w, i);
      if (i < n) {
        if (begins >> i & 1) {
          if (cur >= 0 && mine)
            __stcs(dgrid + row0 + (long long)cur * pairs, acc);
          acc = make_float2(0.f, 0.f);
          cur = __shfl_sync(~0u, cell, i);
        }
        if (mine) madd2(acc, v[i], wi);
      }
    }
    cell = next_cell;
    p = next_p;
    w = next_w;
  }
  if (cur >= 0 && mine) __stcs(dgrid + row0 + (long long)cur * pairs, acc);
}

unsigned blocks_for(long long total, int threads) {
  const long long need = (total + threads - 1) / threads;
  const long long most = 132LL * 16;
  return (unsigned)(need < most ? need : most);
}

}  // namespace

// coords [B, N, 3] float32 -> cell and perm [B N], offsets [B r^3 + 1]
// int32 and weights [B N, 8] float32; counts [B r^3], unsorted [B N] and
// partial [ceil(B r^3 / 4096)] int32 scratch. Six launches on the stream
// (a memset and five kernels).
extern "C" int trilinear_devoxelize_plan_launch(const float* coords,
                                                int* cell, int* perm,
                                                int* offsets, float* weights,
                                                int* counts,
                                                int* unsorted, int* partial,
                                                int b, int n, int r,
                                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long m = (long long)b * r * r * r;
  const int total = b * n;
  cudaError_t err = cudaMemsetAsync(counts, 0, m * sizeof(int), st);
  if (err != cudaSuccess) return err;
  const unsigned blocks = blocks_for(total, kThreads);
  if (total > 0)
    devoxelize_plan_count_kernel<<<blocks, kThreads, 0, st>>>(
        coords, cell, counts, perm, total, n, r);
  const unsigned scan_blocks = (unsigned)((m + kScanChunk - 1) / kScanChunk);
  devoxelize_plan_sums_kernel<<<scan_blocks, kScanThreads, 0, st>>>(
      counts, partial, (int)m);
  devoxelize_plan_offsets_kernel<<<scan_blocks, kScanThreads, 0, st>>>(
      counts, partial, offsets, (int)m);
  if (total > 0) {
    // perm holds each point's slot until the rank pass writes it
    devoxelize_plan_scatter_kernel<<<blocks, kThreads, 0, st>>>(
        cell, offsets, perm, unsorted, total);
    devoxelize_plan_rank_kernel<<<blocks, kThreads, 0, st>>>(
        coords, cell, offsets, unsorted, perm,
        reinterpret_cast<float4*>(weights), total, r);
  }
  return cudaGetLastError();
}

// grid [B, r, r, r, C], coords [B, N, 3] float32 and their plan (perm,
// cell), out [B, N, C]; C % 4 == 0 and grid and out 16-byte aligned (the
// wrapper checks).
extern "C" int trilinear_devoxelize_launch(const float* grid,
                                           const float* coords,
                                           const int* perm, const int* cell,
                                           float* out, int b, int n, int r,
                                           int c, void* stream) {
  const int units = c / 4, chunks = (units + kUnits - 1) / kUnits;
  const int total = b * n;
  if (total == 0 || units == 0) return cudaSuccess;
  const int need = (total + kThreads - 1) / kThreads;
  devoxelize_fwd_kernel<<<dim3(min(need, 132 * 8), chunks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(grid), coords, perm, cell,
      reinterpret_cast<float4*>(out), total, r, units);
  return cudaGetLastError();
}

// g [B, N, C] float32 and the plan of its coordinates (perm, offsets,
// weights), dgrid [B, r, r, r, C], every row of which is written;
// C % 4 == 0 and g and dgrid 16-byte aligned (the wrapper checks).
extern "C" int trilinear_devoxelize_bwd_launch(const float* g,
                                               const int* perm,
                                               const int* offsets,
                                               const float* weights,
                                               float* dgrid, int b, int r,
                                               int c, void* stream) {
  const int pairs = c / 2, chunks = (pairs + kPairs - 1) / kPairs;
  if (b == 0 || pairs == 0) return cudaSuccess;
  const int blocks =
      ((r + kGroup - 1) / kGroup) * ((r + kWarps - 1) / kWarps) * r;
  devoxelize_bwd_kernel<<<dim3(blocks, b * chunks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(g), perm, offsets, weights,
      reinterpret_cast<float2*>(dgrid), r, pairs, chunks);
  return cudaGetLastError();
}
