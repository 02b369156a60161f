// Trilinear devoxelisation: each point reads its voxel grid's features at
// its coordinates, trilinearly interpolated from the 8 cells around it;
// and the grid backward, which adds each point's cotangent, times the
// corner's weight, into the 8 cells it read.
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
// the sum starting from 0. Every product and sum here is an explicit
// __fmul_rn / __fsub_rn / __fadd_rn in that order, so no FMA contraction
// changes a bit: the forward equals the plain version bit for bit. The
// backward adds g[b, n, :] * w into dgrid (zeroed by the wrapper) with
// float atomics, in an order that changes from run to run, so it equals
// a fixed-order sum only where every partial sum is exact (dyadic
// coordinates and cotangents).
//
// Bounds on the H100: device memory. The forward reads at most the grid
// and the coordinates and writes [B, N, C]; 8 multiply-adds a value. At
// PVCNN's first block (B 4, N 40,960, r 64, C 64) the grid is 268 MB and
// the output 42 MB; each point reads 8 rows of C floats, which are shared
// with its neighbours through L2.
//
// Design: a simple kernel that is right. One thread for each (point,
// float4 unit of 4 channels), the flat [B * N, C / 4] index in memory
// order, so a warp's lanes read consecutive 16-byte units of one corner
// row and write consecutive units of the output. C must be a multiple of
// 4 (every shipped width is) and the tensors 16-byte aligned: the
// wrappers raise otherwise, so there is no scalar path.
// Each thread computes its point's corners and weights again (3 loads of
// the same coordinates, broadcast within a warp). The backward adds a
// float4 unit with the 16-byte vector atomicAdd of compute capability
// 9.x, one L2 operation for four channels, and skips units that are all
// zero (a sum that starts at +0 keeps its bits when +-0 is added).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  long long row[8];  // flat cell index of each corner, b * r^3 included
  float w[8];        // its weight, (wx * wy) * wz
};

__device__ __forceinline__ Corners corners(const float* __restrict__ coords,
                                           long long p, int n, int r) {
  const long long b = p / n;
  float f[3];
  int lo[3];
  const float top = (float)(r - 1);
  for (int k = 0; k < 3; ++k) {
    const float c = fminf(fmaxf(coords[p * 3 + k], 0.f), top);
    int l = (int)floorf(c);
    l = min(l, r - 2);
    l = max(l, 0);
    lo[k] = l;
    f[k] = __fsub_rn(c, (float)l);
  }
  Corners out;
  const long long base = b * r * r * (long long)r;
  int i = 0;
  for (int dx = 0; dx < 2; ++dx) {
    const float wx = dx ? f[0] : __fsub_rn(1.f, f[0]);
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? f[1] : __fsub_rn(1.f, f[1]);
      for (int dz = 0; dz < 2; ++dz, ++i) {
        const float wz = dz ? f[2] : __fsub_rn(1.f, f[2]);
        out.w[i] = __fmul_rn(__fmul_rn(wx, wy), wz);
        out.row[i] = base + ((long long)(lo[0] + dx) * r + (lo[1] + dy)) * r +
                     (lo[2] + dz);
      }
    }
  }
  return out;
}

__device__ __forceinline__ float madd(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

__global__ void __launch_bounds__(kThreads)
    devoxelize_vec_kernel(const float4* __restrict__ grid,
                          const float* __restrict__ coords,
                          float4* __restrict__ out, long long total, int n,
                          int r, int units) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long p = i / units;
    const int u = (int)(i - p * units);
    const Corners cn = corners(coords, p, n, r);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = __ldg(grid + cn.row[k] * units + u);
      acc.x = madd(acc.x, v.x, cn.w[k]);
      acc.y = madd(acc.y, v.y, cn.w[k]);
      acc.z = madd(acc.z, v.z, cn.w[k]);
      acc.w = madd(acc.w, v.w, cn.w[k]);
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    devoxelize_bwd_vec_kernel(const float4* __restrict__ g,
                              const float* __restrict__ coords,
                              float4* __restrict__ dgrid, long long total,
                              int n, int r, int units) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long p = i / units;
    const int u = (int)(i - p * units);
    const float4 x = __ldcs(g + i);
    if (x.x == 0.f && x.y == 0.f && x.z == 0.f && x.w == 0.f) continue;
    const Corners cn = corners(coords, p, n, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = cn.w[k];
      atomicAdd(dgrid + cn.row[k] * units + u,
                make_float4(__fmul_rn(x.x, w), __fmul_rn(x.y, w),
                            __fmul_rn(x.z, w), __fmul_rn(x.w, w)));
    }
  }
}

// Blocks for `total` threads' work: enough to cover it, at most what a
// grid-stride loop needs to keep every SM full (16 blocks of 256 an SM).
unsigned blocks_for(long long total) {
  const long long need = (total + kThreads - 1) / kThreads;
  const long long most = 132LL * 16;
  return (unsigned)(need < most ? need : most);
}

}  // namespace

// grid [B, r, r, r, C] and coords [B, N, 3] float32, out [B, N, C];
// C % 4 == 0 and grid and out 16-byte aligned (the wrapper checks).
extern "C" int trilinear_devoxelize_launch(const float* grid,
                                           const float* coords, float* out,
                                           int b, int n, int r, int c,
                                           void* stream) {
  const long long units = c / 4;
  const long long total = (long long)b * n * units;
  if (total == 0) return cudaSuccess;
  devoxelize_vec_kernel<<<blocks_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(grid), coords,
      reinterpret_cast<float4*>(out), total, n, r, (int)units);
  return cudaGetLastError();
}

// g [B, N, C] and coords [B, N, 3] float32, dgrid [B, r, r, r, C] zeroed;
// C % 4 == 0 and g and dgrid 16-byte aligned (the wrapper checks).
extern "C" int trilinear_devoxelize_bwd_launch(const float* g,
                                               const float* coords,
                                               float* dgrid, int b, int n,
                                               int r, int c, void* stream) {
  const long long units = c / 4;
  const long long total = (long long)b * n * units;
  if (total == 0) return cudaSuccess;
  devoxelize_bwd_vec_kernel<<<blocks_for(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(g), coords,
      reinterpret_cast<float4*>(dgrid), total, n, r, (int)units);
  return cudaGetLastError();
}
