// The staged design of the trilinear-devoxelisation pair, measured
// against the shipped one (../trilinear_devoxelize.cu) and not shipped:
// `python3 chip_smoke.py --devox-staged` builds this file on its own and
// times it against the shipped pair in turns, on the shipped plan, at
// PVCNN's four path shapes, a crowded cell and the S3DIS rooms' calls;
// PERF.md keeps the readings. The shipped build does not compile it.
//
// Both kernels give a CTA a tile of 8 x 8 cells in (y, z) and 64 channels
// and walk it along x for up to 8 steps, with a ring of three slabs in
// shared memory filled by cp.async, the next one loading while the
// current two are read.
//
// The forward: the rows of grid slabs x and x + 1 that some lo cell of
// the tile reads (a tile with no point loads nothing), and the plan rows
// (point, 8 weights) of the step's first 128 points; a warp takes 32 of
// the step's points, a lane one point's slab row and weights, the
// half-warps two points at a time through __shfl_sync, a lane a float4
// unit, the corners summed in CORNERS order from 0 with __fmul_rn /
// __fadd_rn: bit-equal to devoxelize_plain.
//
// The grid backward, owner computes with no atomics: the cotangent rows
// and weights of the first 120 points of lo slab x (its tile and one-cell
// halo on the low side, the y rows' CSR runs end to end); a half-warp
// owns a cell of slab x, and for corner k = 0..7 in CORNERS order adds
// the products g * w of the points of lo cell (cell - corner k) in
// ascending point index from +0, from shared memory, or past the staged
// points 16 at a time from device memory; then writes the cell's row
// once, zeros included: bit-equal to devoxelize_grad_plain on the CPU.
//
// C must be a multiple of 4 and the tensors 16-byte aligned.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 16;        // float4 units of a CTA's 64 channels

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

constexpr int kTile = 8;                // a tile's cells along y and along z
constexpr int kSeg = 8;                 // the steps along x a CTA walks
constexpr int kSide = kTile + 1;        // a tile and its one-cell halo
constexpr int kStages = 3;              // slabs in the ring
static_assert(kSeg == kWarps, "a warp sets up each step's slab");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the one committed last has landed
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// the last q in [0, n) with v[q] <= x, for v ascending and v[0] <= x
__device__ __forceinline__ int last_at_most(const int* v, int n, int x) {
  int q = 0;
  for (int k = 1; k < n; ++k) q += v[k] <= x;
  return q;
}

// the exclusive prefix of the lengths v[k + 1] - v[k] of lanes k < n of
// a warp into out[0..n - 1], their total into out[n]
__device__ __forceinline__ void row_bases(const int* first, const int* last,
                                          int stride, int n, int* out) {
  const int lane = threadIdx.x & 31;
  const int len = lane < n ? last[lane * stride] - first[lane * stride] : 0;
  int incl = len;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane < n) out[lane] = incl - len;
  if (lane == n - 1) out[n] = incl;
}

// --------------------------------------------------------------- forward

constexpr int kFwdPoints = 128;         // a step's points with staged plan

struct FwdShared {
  float4 rows[kStages][kSide * kSide][kUnits];  // grid slabs x and x + 1
  float4 weights[2][kFwdPoints][2];  // the step's plan rows: weights
  int perm[2][kFwdPoints];           // and points
  int offs[kSeg][kTile][kSide];      // each step's lo cells' CSR offsets
  int base[kSeg][kTile + 1];         // each y row's first in its step
  unsigned long long occupied[kSeg];  // each step's lo cells with a point
};

__global__ void __launch_bounds__(kThreads)
    devoxelize_fwd_kernel(const float4* __restrict__ grid,
                          const int* __restrict__ perm,
                          const int* __restrict__ offsets,
                          const float4* __restrict__ weights,
                          float4* __restrict__ out, int r, int units,
                          int segs) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdShared& s = *reinterpret_cast<FwdShared*>(smem);
  const int tiles = (r + kTile - 1) / kTile;
  int t = blockIdx.x;
  const int z0 = (t % tiles) * kTile;
  t /= tiles;
  const int y0 = (t % tiles) * kTile;
  t /= tiles;
  const int xa = (t % segs) * kSeg;
  const long long bb = (long long)(t / segs) * r * r * r;
  const int cu0 = blockIdx.y * kUnits, cunits = min(kUnits, units - cu0);
  const int steps = min(kSeg, r - 1 - xa);  // lo x reaches r - 2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kSeg * kTile * kSide; i += kThreads) {
    const int q = i % kSide, ly = i / kSide % kTile, sx = i / (kSide * kTile);
    s.offs[sx][ly][q] =
        sx < steps && y0 + ly < r
            ? __ldg(offsets + flat_cell(bb, r, xa + sx, y0 + ly,
                                        min(z0 + q, r)))
            : 0;
  }
  __syncthreads();
  {
    const int* o = s.offs[warp][0];
    auto has = [&](int c) {
      const int at = c / kTile * kSide + c % kTile;
      return o[at + 1] > o[at];
    };
    const unsigned lo = __ballot_sync(~0u, has(lane)),
                   hi = __ballot_sync(~0u, has(lane + 32));
    if (lane == 0)
      s.occupied[warp] = lo | (unsigned long long)hi << 32;
    row_bases(o, o + kTile, kSide, kTile, s.base[warp]);
  }
  __syncthreads();
  unsigned long long any = 0;
  for (int k = 0; k < kSeg; ++k) any |= s.occupied[k];
  if (!any) return;  // the tile holds no point: nothing to load or write

  // grid slab xa + gt: the rows some lo cell of step gt - 1 or gt reads
  auto load_slab = [&](int gt) {
    if (gt > steps) return;
    const unsigned long long m = (gt > 0 ? s.occupied[gt - 1] : 0ull) |
                                 (gt < steps ? s.occupied[gt] : 0ull);
    if (!m) return;
    float4(*dst)[kUnits] = s.rows[gt % kStages];
    for (int i = tid; i < kSide * kSide * kUnits; i += kThreads) {
      const int row = i / kUnits, u = i % kUnits;
      const int ry = row / kSide, rz = row % kSide;
      bool need = false;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int ly = ry - (d >> 1), lz = rz - (d & 1);
        need |= ly >= 0 && ly < kTile && lz >= 0 && lz < kTile &&
                (m >> (ly * kTile + lz) & 1);
      }
      if (need && u < cunits)
        cp_async16(&dst[row][u],
                   grid + flat_cell(bb, r, xa + gt, y0 + ry, z0 + rz) * units +
                       cu0 + u);
    }
  };
  // step t's first kFwdPoints points: their plan rows
  auto load_points = [&](int t) {
    if (t >= steps || !s.occupied[t]) return;
    const int total = min(s.base[t][kTile], kFwdPoints);
    for (int i = tid; i < 3 * total; i += kThreads) {
      const int slot = i / 3, part = i % 3;
      const int ly = last_at_most(s.base[t], kTile, slot);
      const int j = s.offs[t][ly][0] + slot - s.base[t][ly];
      if (part == 2)
        cp_async4(&s.perm[t & 1][slot], perm + j);
      else
        cp_async16(&s.weights[t & 1][slot][part], weights + 2LL * j + part);
    }
  };

  const int half = lane >> 4, u = lane & 15;
  load_slab(0);
  load_points(0);
  cp_async_commit();
  load_slab(1);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    load_slab(t + 2);
    load_points(t + 1);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();
    const int total = s.base[t][kTile];
    const float4(*lower)[kUnits] = s.rows[t % kStages];
    const float4(*upper)[kUnits] = s.rows[(t + 1) % kStages];
    for (int first = warp * 32; first < total; first += kThreads) {
      // lane i: the step's point first + i, its slab row and weights
      const int i = first + lane;
      int p = 0, row = 0;
      float w[8];
      if (i < total) {
        const int ly = last_at_most(s.base[t], kTile, i);
        const int j = s.offs[t][ly][0] + i - s.base[t][ly];
        row = ly * kSide + last_at_most(s.offs[t][ly], kTile, j);
        float4 w0, w1;
        if (i < kFwdPoints) {
          p = s.perm[t & 1][i];
          w0 = s.weights[t & 1][i][0];
          w1 = s.weights[t & 1][i][1];
        } else {
          p = __ldg(perm + j);
          w0 = __ldg(weights + 2LL * j);
          w1 = __ldg(weights + 2LL * j + 1);
        }
        w[0] = w0.x, w[1] = w0.y, w[2] = w0.z, w[3] = w0.w;
        w[4] = w1.x, w[5] = w1.y, w[6] = w1.z, w[7] = w1.w;
      }
      // the half-warps take the points two at a time, a lane a float4
      const int count = min(32, total - first);
      for (int k2 = 0; k2 < count; k2 += 2) {
        const int src = k2 + half;
        const int pp = __shfl_sync(~0u, p, src);
        const int rr = __shfl_sync(~0u, row, src);
        float ww[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) ww[k] = __shfl_sync(~0u, w[k], src);
        if (src < count && u < cunits) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int at = rr + ((k >> 1) & 1) * kSide + (k & 1);
            madd4(acc, (k >> 2 ? upper : lower)[at][u], ww[k]);
          }
          __stcs(out + (long long)pp * units + cu0 + u, acc);
        }
      }
    }
    __syncthreads();
  }
}

// -------------------------------------------------------------- backward

constexpr int kBwdPoints = 120;         // a lo slab's staged points

struct BwdShared {
  float4 g[kStages][kBwdPoints][kUnits];    // staged cotangent rows
  float4 weights[kStages][kBwdPoints][2];   // and their 8 weights
  int point[kBwdPoints];                    // the slab being staged
  int offs[kSeg + 1][kSide][kSide + 1];     // each lo slab's CSR offsets
  int base[kSeg + 1][kSide + 1];            // each y row's first staged
};

__global__ void __launch_bounds__(kThreads, 2)
    devoxelize_bwd_kernel(const float4* __restrict__ g,
                          const int* __restrict__ perm,
                          const int* __restrict__ offsets,
                          const float* __restrict__ weights,
                          float4* __restrict__ dgrid, int r, int units,
                          int segs) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdShared& s = *reinterpret_cast<BwdShared*>(smem);
  const int tiles = (r + kTile - 1) / kTile;
  int t = blockIdx.x;
  const int z0 = (t % tiles) * kTile;
  t /= tiles;
  const int y0 = (t % tiles) * kTile;
  t /= tiles;
  const int x0 = (t % segs) * kSeg;
  const long long bb = (long long)(t / segs) * r * r * r;
  const int cu0 = blockIdx.y * kUnits, cunits = min(kUnits, units - cu0);
  const int steps = min(kSeg, r - x0);  // the tile's cells x0 .. x0 + steps - 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lo slab sl (x0 - 1 + sl), its lo cells (y0 - 1 + ry, z0 - 1 + q): a
  // cell's points lie in [offs[sl][ry][q], offs[sl][ry][q + 1]); none
  // outside the grid's lo cells [0, r - 2]
  for (int i = tid; i < (kSeg + 1) * kSide * (kSide + 1); i += kThreads) {
    const int q = i % (kSide + 1), ry = i / (kSide + 1) % kSide,
              sl = i / ((kSide + 1) * kSide);
    const int lx = x0 - 1 + sl, ly = y0 - 1 + ry;
    s.offs[sl][ry][q] =
        sl <= steps && lx >= 0 && lx < r - 1 && ly >= 0 && ly < r - 1
            ? __ldg(offsets + flat_cell(bb, r, lx, ly,
                                        min(max(z0 - 1 + q, 0), r)))
            : 0;
  }
  __syncthreads();
  for (int sl = warp; sl <= kSeg; sl += kWarps)
    row_bases(s.offs[sl][0], s.offs[sl][0] + kSide, kSide + 1, kSide,
              s.base[sl]);
  __syncthreads();

  // lo slab sl's first kBwdPoints points (the y rows' runs end to end):
  // their cotangent rows and weights
  auto stage = [&](int sl) {
    const int total = sl <= steps ? min(s.base[sl][kSide], kBwdPoints) : 0;
    __syncthreads();  // the last staging has read s.point
    int j = 0;
    if (tid < total) {
      const int ry = last_at_most(s.base[sl], kSide, tid);
      j = s.offs[sl][ry][0] + tid - s.base[sl][ry];
      s.point[tid] = __ldg(perm + j);
    }
    __syncthreads();
    float4(*gd)[kUnits] = s.g[sl % kStages];
    float4(*wd)[2] = s.weights[sl % kStages];
    if (tid < total) {
      cp_async16(&wd[tid][0], weights + 8LL * j);
      cp_async16(&wd[tid][1], weights + 8LL * j + 4);
    }
    for (int i = tid; i < total * kUnits; i += kThreads) {
      const int slot = i / kUnits, u = i % kUnits;
      if (u < cunits)
        cp_async16(&gd[slot][u],
                   g + (long long)s.point[slot] * units + cu0 + u);
    }
  };

  const int u = tid & 15;
  const unsigned hmask = 0xffffu << (lane & 16);
  stage(0);
  cp_async_commit();
  stage(1);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    stage(t + 2);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();
    // a half-warp a cell of the slab x0 + t, a lane a float4 unit
    for (int c = tid >> 4; c < kTile * kTile; c += kThreads / 16) {
      const int cy = c / kTile, cz = c % kTile;
      if (y0 + cy >= r || z0 + cz >= r) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // the points of lo cell (cell - corner k), in ascending index
        const int sl = t + 1 - (k >> 2), ry = cy + 1 - ((k >> 1) & 1);
        const int* o = s.offs[sl][ry];
        const int q = cz + 1 - (k & 1), a = o[q], n = o[q + 1] - a;
        if (n == 0) continue;
        const int slot0 = s.base[sl][ry] + a - o[0];
        const float4(*gs)[kUnits] = s.g[sl % kStages];
        const float(*ws)[8] =
            reinterpret_cast<const float(*)[8]>(s.weights[sl % kStages]);
        if (slot0 + n <= kBwdPoints) {
          for (int i = 0; i < n; ++i)
            madd4(acc, gs[slot0 + i][u], ws[slot0 + i][k]);
          continue;
        }
        // a run past the staged points: 16 at a time, lane i finding the
        // i-th's row (in shared or device memory) and weight a batch ahead
        auto find = [&](int i, const float4*& src, float& w) {
          src = nullptr;
          w = 0.f;
          if (i >= n) return;
          if (slot0 + i < kBwdPoints) {
            src = gs[slot0 + i];
            w = ws[slot0 + i][k];
          } else {
            src = g + (long long)__ldg(perm + a + i) * units + cu0;
            w = __ldg(weights + 8LL * (a + i) + k);
          }
        };
        const float4* src;
        float w;
        find(u, src, w);
        for (int i0 = 0; i0 < n; i0 += 16) {
          float4 v[16];
#pragma unroll
          for (int q2 = 0; q2 < 16; ++q2) {
            const float4* row = reinterpret_cast<const float4*>(
                __shfl_sync(hmask, reinterpret_cast<unsigned long long>(src),
                            q2, 16));
            if (i0 + q2 < n && u < cunits) v[q2] = row[u];
          }
          const float wi = w;
          find(i0 + 16 + u, src, w);
#pragma unroll
          for (int q2 = 0; q2 < 16; ++q2) {
            const float wq = __shfl_sync(hmask, wi, q2, 16);
            if (i0 + q2 < n) madd4(acc, v[q2], wq);
          }
        }
      }
      if (u < cunits)
        __stcs(dgrid + flat_cell(bb, r, x0 + t, y0 + cy, z0 + cz) * units +
                   cu0 + u,
               acc);
    }
    __syncthreads();
  }
}

}  // namespace

// grid [B, r, r, r, C] float32 and the plan of the coordinates (perm,
// offsets, weights), out [B, N, C]
extern "C" int trilinear_devoxelize_staged_launch(
    const float* grid, const int* perm, const int* offsets,
    const float* weights, float* out, int b, int r, int c, void* stream) {
  const int units = c / 4, chunks = (units + kUnits - 1) / kUnits;
  if (b == 0 || units == 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      devoxelize_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(FwdShared));
  if (err != cudaSuccess) return err;
  const int tiles = (r + kTile - 1) / kTile, segs = (r - 1 + kSeg - 1) / kSeg;
  devoxelize_fwd_kernel<<<dim3(b * segs * tiles * tiles, chunks), kThreads,
                          sizeof(FwdShared),
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(grid), perm, offsets,
      reinterpret_cast<const float4*>(weights),
      reinterpret_cast<float4*>(out), r, units, segs);
  return cudaGetLastError();
}

// g [B, N, C] float32 and the plan of its coordinates (perm, offsets,
// weights), dgrid [B, r, r, r, C], every row of which is written
extern "C" int trilinear_devoxelize_staged_bwd_launch(
    const float* g, const int* perm, const int* offsets,
    const float* weights, float* dgrid, int b, int r, int c, void* stream) {
  const int units = c / 4, chunks = (units + kUnits - 1) / kUnits;
  if (b == 0 || units == 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      devoxelize_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(BwdShared));
  if (err != cudaSuccess) return err;
  const int tiles = (r + kTile - 1) / kTile, segs = (r + kSeg - 1) / kSeg;
  devoxelize_bwd_kernel<<<dim3(b * segs * tiles * tiles, chunks), kThreads,
                          sizeof(BwdShared),
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(g), perm, offsets, weights,
      reinterpret_cast<float4*>(dgrid), r, units, segs);
  return cudaGetLastError();
}
