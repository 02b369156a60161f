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
// the cloud (9 float operations a point) and an argmax over the cloud
// whose result the next step needs. The points are read from device
// memory once, so a step costs the pass over the points that one SM holds
// (issue-bound: about a dozen instructions a point) and the latency of the
// argmax's chain: reductions, a barrier, the exchange between SMs.
//
// Design: a cloud is split over a thread-block cluster of C CTAs (C = 1,
// 2, 4, 8 or 16, one cloud a cluster, grid C x B), each CTA holding up to
// a few thousand points, PPT a thread (the plan: 2), with their
// coordinates and running minimum in registers: a step reads no memory
// but the exchange's posts. A masked point starts at dist -1, which
// min(-1, d) keeps, a slot without a point at -inf. A step's argmax runs
// on keys: dist's bits mapped to an order-preserving uint32 (xor
// 0xFFFFFFFF for a negative value, 0x80000000 otherwise, so -inf < -1 <
// 0 < +inf), one redux.sync max of the key and one redux.sync min of the
// index over the lanes holding it: the lowest index at ties, in two
// instructions. Each warp posts its winner (key, index, x, y, z) to
// shared memory; after one __syncthreads warp 0 reduces the posts, and
// its lanes 0 to C - 1 send the CTA's winner to slot [parity][rank] of
// every CTA of the cluster by st.async (distributed shared memory), whose
// bytes complete that CTA's mbarrier [parity] (expecting C posts of 20
// bytes a step); every thread waits on its own CTA's mbarrier, reduces
// the C posts and takes the winner's coordinates from its post. A cluster
// barrier (arrive.release / wait.acquire) in place of the mbarrier cost
// more a step on the H100 than the step's pass over the points; the
// mbarrier waits only for the posts' one-way trip. The posts and mbarriers
// alternate between two sets, so nothing else orders the steps: a CTA
// sends step s + 2's post only after it has every CTA's post of step
// s + 1, which each CTA sends after all its threads have read step s's.
// One CTA (C = 1) skips the exchange: every warp reduces the warps' posts
// after the one __syncthreads; one warp needs no barrier at all.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 8;  // points a thread, a power of two
constexpr int kMaxCluster = 16;   // CTAs a cluster (16: non-portable)
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr unsigned kNone = 0xFFFFFFFFu;  // the index of no point

// a winner: its key, index and coordinates (two 16-byte words)
struct alignas(16) Post {
  unsigned key, idx;
  float x, y, z, pad[3];
};

// dist's bits as a uint32 in the floats' order
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The lane of the warp's winner: the largest key, the lowest index
// among the lanes holding it; every lane learns it.
__device__ __forceinline__ int warp_winner(unsigned key, unsigned idx) {
  const unsigned top = __reduce_max_sync(kAll, key);
  const unsigned low = __reduce_min_sync(kAll, key == top ? idx : kNone);
  return __ffs(__ballot_sync(kAll, key == top && idx == low)) - 1;
}

// The slot of the winner among posts[0, count): lane j reads post j.
__device__ __forceinline__ int post_winner(const Post* posts, int count,
                                           int lane) {
  const bool has = lane < count;
  return warp_winner(has ? posts[lane].key : 0u,
                     has ? posts[lane].idx : kNone);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Waits for the phase of parity ``parity`` of the mbarrier at shared
// address ``bar``; traps rather than hang where the phase never ends.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

// p into ``slot`` of the CTA of cluster rank ``rank``: two st.async whose
// 20 bytes complete that CTA's mbarrier at the address of ``bar`` there.
__device__ __forceinline__ void post_to(const Post* slot, const void* bar,
                                        unsigned rank, const Post& p) {
  unsigned remote, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %2, %4;\n"
               "mapa.shared::cluster.u32 %1, %3, %4;"
               : "=r"(remote), "=r"(rbar)
               : "r"(smem_u32(slot)), "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0+16], %6, [%5];"
      :: "r"(remote), "r"(p.key), "r"(p.idx), "r"(__float_as_uint(p.x)),
         "r"(__float_as_uint(p.y)), "r"(rbar), "r"(__float_as_uint(p.z))
      : "memory");
}

// kOneWarp: a CTA of one warp; kCluster: C > 1 CTAs a cloud.
template <int PPT, bool kOneWarp, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ points,
               const unsigned char* __restrict__ mask, int* __restrict__ out,
               int n, int m, int per_cta) {
  __shared__ Post wpost[2][32];           // the warps' winners
  __shared__ Post cpost[2][kMaxCluster];  // the cluster's CTAs' winners
  __shared__ unsigned long long bar[2];   // a step's C posts have landed
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = blockDim.x / 32;
  const unsigned rank = kCluster ? cluster_rank() : 0u;
  const int nc = gridDim.x;
  const long long b = blockIdx.y;
  const float* src = points + b * n * 3;
  const unsigned char* msk = mask == nullptr ? nullptr : mask + b * n;
  int* sel = out + b * m;
  const int i0 = (int)rank * per_cta + tid;  // this thread's first point
  const int end = min(n, (int)rank * per_cta + per_cta);

  // dist: +inf for a valid point, -1 for a masked one (min(-1, d) stays
  // -1: never chosen while a valid one is left), -inf for no point
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int u = 0; u < PPT; ++u) {
    const int i = i0 + u * blockDim.x;
    px[u] = py[u] = pz[u] = 0.f;
    dist[u] = -CUDART_INF_F;
    if (i < end) {
      px[u] = src[3 * i];
      py[u] = src[3 * i + 1];
      pz[u] = src[3 * i + 2];
      dist[u] = msk == nullptr || msk[i] != 0 ? CUDART_INF_F : -1.0f;
    }
  }
  float lx = src[0], ly = src[1], lz = src[2];
  if (rank == 0 && tid == 0) sel[0] = 0;
  unsigned phase = 0u;  // bit k: the parity of bar[k]'s current phase
  if constexpr (kCluster) {
    // every CTA of the cluster has started, its barriers set, before a
    // post reaches it
    if (tid == 0)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   "mbarrier.init.shared::cta.b64 [%1], 1;\n"
                   "fence.mbarrier_init.release.cluster;"
                   :: "r"(smem_u32(&bar[0])), "r"(smem_u32(&bar[1]))
                   : "memory");
    cluster_barrier();
  }
  for (int s = 1; s < m; ++s) {
    const int par = s & 1;
    if constexpr (kCluster) {
      // this step's C posts, 20 bytes each
      if (tid == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                     "%1;" :: "r"(smem_u32(&bar[par])), "r"(nc * 20)
                     : "memory");
    }
    float bv = -CUDART_INF_F;
    unsigned bi = kNone;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      dist[u] = fminf(dist[u], sq_dist(px[u], py[u], pz[u], lx, ly, lz));
      if (dist[u] > bv) {  // the index rises with u: the lower one stays
        bv = dist[u];
        bi = (unsigned)(i0 + u * blockDim.x);
      }
    }
    Post p;
    p.key = order_key(bv);
    p.idx = bi;
    p.x = p.y = p.z = 0.f;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      if ((unsigned)(i0 + u * blockDim.x) == bi) {
        p.x = px[u];
        p.y = py[u];
        p.z = pz[u];
      }
    }
    const int wl = warp_winner(p.key, bi);
    Post win;  // the cloud's winner, in every thread
    if constexpr (kOneWarp && !kCluster) {
      win.idx = __shfl_sync(kAll, p.idx, wl);
      win.x = __shfl_sync(kAll, p.x, wl);
      win.y = __shfl_sync(kAll, p.y, wl);
      win.z = __shfl_sync(kAll, p.z, wl);
    } else {
      const Post* cta = wpost[par];
      if (lane == wl) wpost[par][warp] = p;
      if constexpr (kOneWarp) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      if constexpr (kCluster) {
        if (warp == 0) {
          const Post& w = cta[post_winner(cta, nw, lane)];
          if (lane < nc) post_to(&cpost[par][rank], &bar[par], lane, w);
        }
        mbar_wait(smem_u32(&bar[par]), (phase >> par) & 1u);
        phase ^= 1u << par;
        win = cpost[par][post_winner(cpost[par], nc, lane)];
      } else {
        win = cta[post_winner(cta, nw, lane)];
      }
    }
    lx = win.x;
    ly = win.y;
    lz = win.z;
    if (rank == 0 && tid == 0) sel[s] = (int)win.idx;
  }
}

// The kernel instance for PPT points a thread, and its launch
// configuration for B clouds of C CTAs of ``threads``.
template <int PPT, bool kOneWarp, bool kCluster>
cudaError_t run(const float* points, const unsigned char* mask, int* out,
                int b, int n, int m, int cluster, int threads, int per_cta,
                cudaStream_t stream, int* clusters) {
  auto kernel = fps_kernel<PPT, kOneWarp, kCluster>;
  if (cluster == kMaxCluster) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, points, mask, out, n, m,
                                       per_cta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int PPT>
cudaError_t pick(const float* points, const unsigned char* mask, int* out,
                 int b, int n, int m, int cluster, int threads, int per_cta,
                 cudaStream_t st, int* clusters) {
  const bool one = threads == 32, many = cluster > 1;
  if (one && many)
    return run<PPT, true, true>(points, mask, out, b, n, m, cluster, threads,
                                per_cta, st, clusters);
  if (one)
    return run<PPT, true, false>(points, mask, out, b, n, m, cluster,
                                 threads, per_cta, st, clusters);
  if (many)
    return run<PPT, false, true>(points, mask, out, b, n, m, cluster,
                                 threads, per_cta, st, clusters);
  return run<PPT, false, false>(points, mask, out, b, n, m, cluster, threads,
                                per_cta, st, clusters);
}

// Checks the plan and runs (or, with ``clusters``, queries) its instance.
cudaError_t dispatch(const float* points, const unsigned char* mask,
                     int* out, int b, int n, int m, int cluster, int threads,
                     void* stream, int* clusters) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  const int per_cta = (n + cluster - 1) / cluster;
  const int per = (per_cta + threads - 1) / threads;
  if (per > kMaxPerThread) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per <= 1)
    return pick<1>(points, mask, out, b, n, m, cluster, threads, per_cta, st,
                   clusters);
  if (per <= 2)
    return pick<2>(points, mask, out, b, n, m, cluster, threads, per_cta, st,
                   clusters);
  if (per <= 4)
    return pick<4>(points, mask, out, b, n, m, cluster, threads, per_cta, st,
                   clusters);
  return pick<8>(points, mask, out, b, n, m, cluster, threads, per_cta, st,
                 clusters);
}

}  // namespace

// points [B, N, 3] float32, mask [B, N] bool or null; out [B, m] int32 is
// written. cluster: CTAs a cloud, a power of two up to 16; threads: a
// multiple of 32 up to 1,024, with ceil(ceil(N / cluster) / threads) <= 8
// (ops/cuda/sampling.py fps_plan).
extern "C" int fps_launch(const float* points, const unsigned char* mask,
                          int* out, int b, int n, int m, int cluster,
                          int threads, void* stream) {
  return dispatch(points, mask, out, b, n, m, cluster, threads, stream,
                  nullptr);
}

// The clusters of the launch that fps_launch would make for clouds of N
// points which the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError.
extern "C" int fps_max_clusters(int n, int cluster, int threads) {
  int clusters = 0;
  const cudaError_t err = dispatch(nullptr, nullptr, nullptr, 1, n, 1,
                                   cluster, threads, nullptr, &clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}
