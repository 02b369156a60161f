// Furthest point sampling: for each cloud of a batch, m indices chosen
// greedily, each the point furthest from those chosen so far.
//
// Replaces open3d_ml_tpu/ops/sampling.py furthest_point_sampling, which is
// not a Pallas kernel but one XLA fori_loop on the TPU; in plain PyTorch
// the same loop is a Python loop of m steps of several launches each
// (fps_plain in open3d_ml_tpu_torch/ops/cuda/sampling.py). Its contract:
// start at index 0; each step computes d = (dx*dx + dy*dy) + dz*dz of every
// point to the last chosen one, dist = min(dist, d), and takes the argmax
// of dist, the lowest index first among equal values; a masked point
// carries dist = -1 and so is never chosen while a valid one is left.
// Every product, difference and sum here is an explicit __fmul_rn /
// __fsub_rn / __fadd_rn in that order, so no FMA contraction changes a bit
// and the choices equal the plain version's.
//
// Bounds on the H100: the work is m dependent steps (5,440 in one
// PointTransformer forward: 4,096 + 1,024 + 256 + 64), each a pass over
// the cloud (9 float operations a point) and a block-wide argmax whose
// result the next step needs. At N = 16,384 a step is 147,456 operations,
// so the steps are bound by one SM's issue rate (128 lanes a clock) and the
// barrier latency of each step's reduction, not by memory: the points are
// read from device memory once.
//
// Design: one block per cloud, up to 1,024 threads, each thread holding the
// running minimum of its PPT points (i = thread + u * threads) in
// registers. The coordinates are staged once in shared memory as [N, 3]
// (a stride of 3 words between neighbouring threads meets no bank
// conflict), or read through the read-only cache where 12 N bytes do not
// fit in a block's shared memory. A step reduces (dist, index) in each
// warp by shuffles, posts one pair a warp to shared memory, and after one
// barrier every warp reduces the posted pairs itself with a butterfly, so
// every thread learns the winner without a second barrier (the posts
// alternate between two buffers, so a fast warp's next post never
// overwrites pairs a slow warp still reads).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 32;  // points a thread, a power of two
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
// bytes of dynamic shared memory the staged coordinates may take: the
// limit less the static posts
constexpr int kStageLimit = kSmemLimit - 1024;

// (v, i) before (w, j): the larger value, then the lower index
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int PPT, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ points,
               const unsigned char* __restrict__ mask, int* __restrict__ out,
               int n, int m) {
  extern __shared__ float staged[];
  __shared__ float post_v[2][32];
  __shared__ int post_i[2][32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = blockDim.x / 32;
  const long long b = blockIdx.x;
  const float* src = points + b * n * 3;
  const unsigned char* msk = mask == nullptr ? nullptr : mask + b * n;
  int* sel = out + b * m;
  // coordinate j of the cloud: a shared-memory load where it is staged
  auto at = [&](int j) -> float {
    if constexpr (kStaged) {
      return staged[j];
    } else {
      return __ldg(src + j);
    }
  };

  if constexpr (kStaged) {
    for (int j = tid; j < 3 * n; j += blockDim.x) staged[j] = src[j];
    __syncthreads();
  }
  float dist[PPT];
  unsigned valid = 0u;  // bit u: point tid + u * threads exists, unmasked
#pragma unroll
  for (int u = 0; u < PPT; ++u) {
    const int i = tid + u * blockDim.x;
    if (i < n && (msk == nullptr || msk[i] != 0)) valid |= 1u << u;
    dist[u] = (valid >> u) & 1u ? CUDART_INF_F : -1.0f;
  }
  if (tid == 0) sel[0] = 0;
  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float lx = at(3 * last), ly = at(3 * last + 1),
                lz = at(3 * last + 2);
    float bv = -CUDART_INF_F;
    int bi = n;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int i = tid + u * blockDim.x;
      if (i < n) {
        const float d = (valid >> u) & 1u
                            ? sq_dist(at(3 * i), at(3 * i + 1),
                                      at(3 * i + 2), lx, ly, lz)
                            : -1.0f;
        dist[u] = fminf(dist[u], d);
        if (dist[u] > bv) {  // i rises with u: the lower index stays
          bv = dist[u];
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv, off);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int par = s & 1;
    if (lane == 0) {
      post_v[par][warp] = bv;
      post_i[par][warp] = bi;
    }
    __syncthreads();
    bv = lane < nw ? post_v[par][lane] : -CUDART_INF_F;
    bi = lane < nw ? post_i[par][lane] : n;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv, off);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    last = bi;
    if (tid == 0) sel[s] = last;
  }
}

template <int PPT>
cudaError_t launch(const float* points, const unsigned char* mask, int* out,
                   int b, int n, int m, int threads, cudaStream_t stream) {
  const int staged = 3 * n * (int)sizeof(float);
  if (staged <= kStageLimit) {
    // the default 48 KB holds the static posts too, so opt in every time
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PPT, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        staged);
    if (err != cudaSuccess) return err;
    fps_kernel<PPT, true><<<b, threads, staged, stream>>>(points, mask, out,
                                                          n, m);
  } else {
    fps_kernel<PPT, false><<<b, threads, 0, stream>>>(points, mask, out, n,
                                                       m);
  }
  return cudaGetLastError();
}

}  // namespace

// points [B, N, 3] float32, mask [B, N] bool or null; out [B, m] int32 is
// written. threads: a multiple of 32 up to 1,024 with N <= 32 * threads
// (ops/cuda/sampling.py fps_threads).
extern "C" int fps_launch(const float* points, const unsigned char* mask,
                          int* out, int b, int n, int m, int threads,
                          void* stream) {
  if (b < 1 || n < 1 || m < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return cudaErrorInvalidValue;
  const int per = (n + threads - 1) / threads;
  if (per > kMaxPerThread) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per <= 1) return launch<1>(points, mask, out, b, n, m, threads, st);
  if (per <= 2) return launch<2>(points, mask, out, b, n, m, threads, st);
  if (per <= 4) return launch<4>(points, mask, out, b, n, m, threads, st);
  if (per <= 8) return launch<8>(points, mask, out, b, n, m, threads, st);
  if (per <= 16) return launch<16>(points, mask, out, b, n, m, threads, st);
  return launch<32>(points, mask, out, b, n, m, threads, st);
}
