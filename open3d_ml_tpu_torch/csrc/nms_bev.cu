// Greedy rotated-BEV NMS over boxes already in score order, for R rows at
// once: keep box i when it is valid and no kept box before it overlaps it
// by an IoU above the threshold.
//
// Replaces the JAX package's nms_bev (open3d_ml_tpu/ops/nms.py:17-44), an
// XLA IoU matrix and a fori_loop of N steps with no pallas_call. Its
// callers on the port's card path are PointRCNN's proposal layer (two
// buckets of up to 6,300 and 2,700 candidates, padded to one N), its
// refinement's 100 rois, and PointPillars' decode ([B, classes] rows of
// 100). The plain version, nms_bev_plain in
// open3d_ml_tpu_torch/ops/cuda/nms.py, builds the IoU matrix with
// ops/iou.py: about 2.6 kB of intermediates a pair, some 105 GB at
// N = 6,300, more than the card holds; it runs in row blocks.
//
// Two kernels, the reference's iou3d NMS with its sweep on the device:
//
// * nms_mask_kernel: one block of 64 threads for each (row block, column
//   block at or after it) of one row. The column block's 64 boxes (corners,
//   cos, sin, area) are staged in shared memory; each thread takes one row
//   box i and computes its IoU with the later boxes j of the column block,
//   writing one uint64 word of "IoU(i, j) > threshold" bits: a mask
//   [R, N, ceil(N / 64)], 10 MB at two rows of 6,300. Invalid boxes
//   neither suppress nor get a bit.
// * nms_sweep_kernel: one warp a row walks the word blocks in score order.
//   It keeps the "removed" bits in shared memory; for a block it reads the
//   64 boxes' words of that block, settles their 64 decisions by shuffles
//   in order, then ORs the kept boxes' words of all later blocks in at
//   once (independent loads, eight in flight a lane, then shared-memory
//   atomics). N dependent steps, none through the host.
//
// The IoU follows ops/iou.py _rotated_intersection_area step for step: the
// corners, the 8 corner-in-box tests and the 16 edge intersections with
// the same _EPS tests, the masked centroid, atan2f angles, a stable sort
// by (angle, slot) and the shoelace sum, zero below 3 candidates; each
// product, sum and quotient is an explicit round-to-nearest intrinsic in
// the plain version's order, and cosf, sinf and atan2f are the ones
// torch's CUDA operators call. The centroid and the shoelace sum run over
// the candidates in slot and in sorted order; torch's and XLA's sums over
// 24 entries have no fixed order, so the IoU may differ from the plain
// version's in its last bits, and a keep decision only where an IoU lies
// within that of the threshold. A pair whose bounding circles are apart
// by more than a rounding margin gets IoU 0 without the clip, as the clip
// finds no candidate there.
//
// Bounds on the H100: the pairs' clips are float work (a few hundred
// operations an overlapping pair, atan2f and the sort by far the most),
// the boxes a few hundred kB; the sweep is N dependent steps, latency
// bound. The threads of a warp take different row boxes, so the clip's
// data-dependent loops diverge; nothing here is tuned yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // boxes a word, threads of a mask block
constexpr int kCand = 24;      // candidate vertices of one intersection
constexpr float kEps = 1e-8f;  // ops/iou.py _EPS
constexpr int kFields = 16;    // floats of a staged box
constexpr int kInFlight = 8;   // mask loads a sweep lane keeps in flight

struct Box {
  float x, y, w, h, c, s, area, r;
  float cx[4], cy[4];
};

__device__ __forceinline__ void make_box(const float* b, Box& o) {
  o.x = b[0];
  o.y = b[1];
  o.w = b[2];
  o.h = b[3];
  o.c = cosf(b[4]);
  o.s = sinf(b[4]);
  o.area = __fmul_rn(o.w, o.h);
  // the bounding circle, only for the early out
  o.r = 0.5f * sqrtf(o.w * o.w + o.h * o.h);
  const float hw = __fmul_rn(o.w, 0.5f), hh = __fmul_rn(o.h, 0.5f);
  const float dx[4] = {hw, hw, -hw, -hw};
  const float dy[4] = {-hh, hh, hh, -hh};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // x + dx * cos - dy * sin, y + dx * sin + dy * cos
    o.cx[k] = __fsub_rn(__fadd_rn(o.x, __fmul_rn(dx[k], o.c)),
                        __fmul_rn(dy[k], o.s));
    o.cy[k] = __fadd_rn(__fadd_rn(o.y, __fmul_rn(dx[k], o.s)),
                        __fmul_rn(dy[k], o.c));
  }
}

__device__ __forceinline__ void store_box(const Box& b, float (*col)[kBlock],
                                          int t) {
  const float f[kFields] = {b.x,     b.y,     b.w,     b.h,
                            b.c,     b.s,     b.area,  b.r,
                            b.cx[0], b.cx[1], b.cx[2], b.cx[3],
                            b.cy[0], b.cy[1], b.cy[2], b.cy[3]};
#pragma unroll
  for (int k = 0; k < kFields; ++k) col[k][t] = f[k];
}

__device__ __forceinline__ void load_box(float (*col)[kBlock], int u,
                                         Box& b) {
  b.x = col[0][u];
  b.y = col[1][u];
  b.w = col[2][u];
  b.h = col[3][u];
  b.c = col[4][u];
  b.s = col[5][u];
  b.area = col[6][u];
  b.r = col[7][u];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.cx[k] = col[8 + k][u];
    b.cy[k] = col[12 + k][u];
  }
}

// The point (x, y) inside box b, within _EPS (ops/iou.py _points_in_box).
__device__ __forceinline__ bool in_box(float x, float y, const Box& b) {
  const float px = __fsub_rn(x, b.x), py = __fsub_rn(y, b.y);
  const float lx = __fadd_rn(__fmul_rn(px, b.c), __fmul_rn(py, b.s));
  const float ly = __fadd_rn(-__fmul_rn(px, b.s), __fmul_rn(py, b.c));
  return fabsf(lx) <= __fadd_rn(__fmul_rn(b.w, 0.5f), kEps) &&
         fabsf(ly) <= __fadd_rn(__fmul_rn(b.h, 0.5f), kEps);
}

// Intersection area of a and b; px, py, pa: this thread's column (t) of
// the block's candidate scratch in shared memory.
__device__ float inter_area(const Box& a, const Box& b, float (*px)[kBlock],
                            float (*py)[kBlock], float (*pa)[kBlock],
                            int t) {
  int cnt = 0;
  float sx = 0.f, sy = 0.f;
  // candidates in slot order: a's corners in b, b's corners in a, then
  // the edge intersections (a's edge i, b's edge j) at slot 8 + 4 i + j
  auto take = [&](float x, float y) {
    px[cnt][t] = x;
    py[cnt][t] = y;
    sx = __fadd_rn(sx, x);
    sy = __fadd_rn(sy, y);
    ++cnt;
  };
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (in_box(a.cx[k], a.cy[k], b)) take(a.cx[k], a.cy[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (in_box(b.cx[k], b.cy[k], a)) take(b.cx[k], b.cy[k]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d1x = __fsub_rn(a.cx[(i + 1) % 4], a.cx[i]);
    const float d1y = __fsub_rn(a.cy[(i + 1) % 4], a.cy[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d2x = __fsub_rn(b.cx[(j + 1) % 4], b.cx[j]);
      const float d2y = __fsub_rn(b.cy[(j + 1) % 4], b.cy[j]);
      const float den = __fsub_rn(__fmul_rn(d1x, d2y), __fmul_rn(d1y, d2x));
      const float ex = __fsub_rn(b.cx[j], a.cx[i]);
      const float ey = __fsub_rn(b.cy[j], a.cy[i]);
      const float tn = __fsub_rn(__fmul_rn(ex, d2y), __fmul_rn(ey, d2x));
      const float sn = __fsub_rn(__fmul_rn(ex, d1y), __fmul_rn(ey, d1x));
      const bool nz = fabsf(den) > kEps;
      const float ds = nz ? den : 1.0f;
      const float tt = __fdiv_rn(tn, ds), ss = __fdiv_rn(sn, ds);
      // 1 + _EPS rounds to 1 in float32
      if (nz && tt >= -kEps && tt <= 1.0f && ss >= -kEps && ss <= 1.0f)
        take(__fadd_rn(a.cx[i], __fmul_rn(tt, d1x)),
             __fadd_rn(a.cy[i], __fmul_rn(tt, d1y)));
    }
  }
  if (cnt < 3) return 0.f;
  const float cenx = __fdiv_rn(sx, (float)cnt);
  const float ceny = __fdiv_rn(sy, (float)cnt);
  for (int k = 0; k < cnt; ++k)
    pa[k][t] = atan2f(__fsub_rn(py[k][t], ceny), __fsub_rn(px[k][t], cenx));
  // stable insertion sort by angle: equal angles keep their slot order
  for (int k = 1; k < cnt; ++k) {
    const float x = px[k][t], y = py[k][t], g = pa[k][t];
    int m = k;
    for (; m > 0 && pa[m - 1][t] > g; --m) {
      px[m][t] = px[m - 1][t];
      py[m][t] = py[m - 1][t];
      pa[m][t] = pa[m - 1][t];
    }
    px[m][t] = x;
    py[m][t] = y;
    pa[m][t] = g;
  }
  float sum = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const int n = k + 1 < cnt ? k + 1 : 0;
    sum = __fadd_rn(sum, __fsub_rn(__fmul_rn(px[k][t], py[n][t]),
                                   __fmul_rn(px[n][t], py[k][t])));
  }
  return __fmul_rn(0.5f, fabsf(sum));
}

__global__ void __launch_bounds__(kBlock)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const unsigned char* __restrict__ valid, int n,
                    int words, float thr,
                    unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // the sweep reads no word before a row's block
  const long long r = blockIdx.z;
  const float* bx = boxes + r * n * 5;
  const unsigned char* vd = valid + r * n;
  __shared__ float col[kFields][kBlock];
  __shared__ bool col_valid[kBlock];
  __shared__ float px[kCand][kBlock], py[kCand][kBlock], pa[kCand][kBlock];
  const int t = threadIdx.x;
  const int j0 = cb * kBlock;
  col_valid[t] = false;
  if (j0 + t < n) {
    Box b;
    make_box(bx + (long long)(j0 + t) * 5, b);
    store_box(b, col, t);
    col_valid[t] = vd[j0 + t] != 0;
  }
  __syncthreads();
  const int i = rb * kBlock + t;
  if (i >= n) return;
  unsigned long long bits = 0ull;
  if (vd[i]) {
    Box a;
    make_box(bx + (long long)i * 5, a);
    const int stop = min(kBlock, n - j0);
    for (int u = cb == rb ? t + 1 : 0; u < stop; ++u) {
      if (!col_valid[u]) continue;
      Box b;
      load_box(col, u, b);
      float iou = 0.f;
      const float dx = b.x - a.x, dy = b.y - a.y;
      const float reach =
          a.r + b.r + 1e-3f +
          1e-5f * (fabsf(a.x) + fabsf(a.y) + fabsf(b.x) + fabsf(b.y));
      if (!(dx * dx + dy * dy > reach * reach)) {
        const float inter = inter_area(a, b, px, py, pa, t);
        const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
        iou = __fdiv_rn(inter, fmaxf(uni, kEps));
      }
      if (iou > thr) bits |= 1ull << u;
    }
  }
  mask[(r * n + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(32)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ valid, int n,
                     int words, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ int kept_list[kBlock];
  const long long r = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + r * n * words;
  const unsigned char* vd = valid + r * n;
  unsigned char* kp = keep + r * n;
  // invalid boxes (and the slots past N) start removed
  for (int w = lane; w < words; w += 32) {
    unsigned long long bits = 0ull;
    for (int b = 0; b < kBlock; ++b) {
      const int j = w * kBlock + b;
      if (j >= n || !vd[j]) bits |= 1ull << b;
    }
    removed[w] = bits;
  }
  __syncwarp();
  for (int w = 0; w < words; ++w) {
    const int base = w * kBlock;
    unsigned long long rem = removed[w];
    unsigned long long kept = 0ull;
    int nk = 0;
    if (rem != ~0ull) {
      // the block's own words: rows base + lane and base + 32 + lane
      const unsigned long long d0 =
          base + lane < n ? m[(long long)(base + lane) * words + w] : 0ull;
      const unsigned long long d1 =
          base + 32 + lane < n ? m[(long long)(base + 32 + lane) * words + w]
                               : 0ull;
      for (int b = 0; b < kBlock; ++b) {  // uniform over the warp
        const unsigned long long row =
            __shfl_sync(0xffffffffu, b < 32 ? d0 : d1, b & 31);
        if (!((rem >> b) & 1ull)) {
          kept |= 1ull << b;
          rem |= row;
          if (lane == 0) kept_list[nk] = b;
          ++nk;
        }
      }
    }
    for (int b = lane; b < kBlock; b += 32)
      if (base + b < n) kp[base + b] = (kept >> b) & 1ull;
    __syncwarp();
    // the kept boxes' words of every later block: (kept box, word) pairs
    // over the lanes, kInFlight loads a lane issued before their ORs
    const int later = words - w - 1, pairs = nk * later;
    for (int p0 = lane; p0 < pairs; p0 += 32 * kInFlight) {
      unsigned long long got[kInFlight];
      int at[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int p = p0 + 32 * u;
        at[u] = -1;
        if (p < pairs) {
          const int b = kept_list[p / later];
          at[u] = w + 1 + p % later;
          got[u] = m[(long long)(base + b) * words + at[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (at[u] >= 0) atomicOr(&removed[at[u]], got[u]);
    }
    __syncwarp();
  }
}

}  // namespace

// boxes [R, N, 5] float32 (x, y, w, h, angle) in score order, valid [R, N]
// bool; keep [R, N] bool is written in score order; mask [R, N,
// ceil(N / 64)] uint64 is scratch the kernels fill and read. thr: the IoU
// above which a kept box suppresses a later one.
extern "C" int nms_bev_launch(const float* boxes, const unsigned char* valid,
                              unsigned long long* mask, unsigned char* keep,
                              int r, int n, float thr, void* stream) {
  if (r < 1 || r > 65535 || n < 1) return cudaErrorInvalidValue;
  const int words = (n + kBlock - 1) / kBlock;
  const size_t shared = (size_t)words * sizeof(unsigned long long);
  if (words > 65535 || shared > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, r), kBlock, 0, st>>>(boxes, valid, n,
                                                           words, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_sweep_kernel<<<r, 32, shared, st>>>(mask, valid, n, words, keep);
  return cudaGetLastError();
}
