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
// * nms_mask_kernel: one block of 8 warps for each tile (64 row boxes,
//   64 column boxes at or after them) of one row, the grid counting only
//   those tiles. The tile's 128 boxes (corners, cos, sin, area, bounding
//   radius) are staged in shared memory; the block tests the bounding
//   circles of its 4,096 pairs and compacts the pairs that meet into a
//   list (ballot + popc); then a warp clips one listed pair at a time:
//   lanes 0-7 run the corner-in-box tests, lanes 8-23 the 16 edge
//   intersections, the centroid and the shoelace are warp sums in one
//   fixed butterfly order, and the sort by (angle, slot) is a bitonic sort
//   over the lanes. Each row box gets one uint64 word a tile of
//   "IoU(i, j) > threshold" bits: a mask [R, N, ceil(N / 64) + 1], of
//   which only the words at or after a row's own block are written and
//   read, and, last, each box's column word of its own block (the earlier
//   boxes there that suppress it). Invalid boxes neither suppress nor get
//   a bit.
// * nms_sweep_kernel: one block of 16 warps a row walks the word blocks in
//   score order with the "removed" bits in shared memory. Warp 0 settles a
//   block's 64 decisions from the column words it holds in registers, two
//   a lane: greedy NMS inside the block is the one fixed point of "keep j
//   when it is a candidate and no kept i < j suppresses it", which rounds
//   of that rule from "every candidate kept" reach within the longest
//   suppression chain plus one (a ballot a round; the plain version's
//   greedy pass). One thread walking the kept boxes with __ffsll instead
//   paid a shared load and a few dependent integer operations a kept box,
//   most of the sweep where most boxes are kept. Then all the block's
//   threads OR the kept boxes' words of every later block in, (kept box,
//   word) pairs over the threads with 8 loads a thread in flight before
//   their shared atomics; meanwhile warp 0 has loaded the next block's
//   column words.
//   N dependent steps, none through the host.
//
// The IoU follows ops/iou.py _rotated_intersection_area step for step: the
// corners, the 8 corner-in-box tests and the 16 edge intersections with
// the same _EPS tests, the masked centroid, atan2f angles, a stable sort
// by (angle, slot) and the shoelace sum, zero below 3 candidates; each
// product, sum and quotient is an explicit round-to-nearest intrinsic in
// the plain version's order, and cosf, sinf and atan2f are the ones
// torch's CUDA operators call. The centroid's and the shoelace's sums run
// over the lanes in a butterfly's order; torch's and XLA's sums over 24
// entries have no fixed order, so the IoU may differ from the plain
// version's in its last bits, and a keep decision only where an IoU lies
// within that of the threshold. A pair whose bounding circles are apart
// by more than a rounding margin gets IoU 0 without the clip, as the clip
// finds no candidate there.
//
// Bounds on the H100: the pairs' clips are float work (a few hundred
// operations an overlapping pair, atan2f and the sort by far the most),
// the boxes a few hundred kB; the sweep is N dependent steps, latency
// bound. A warp a pair keeps the clip's lanes in step (the pairs' data-
// dependent candidate counts no longer diverge a warp), and the sweep's
// chain is a few ballots and two barriers a block of 64 boxes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;          // boxes a word, a tile's side
constexpr int kMaskThreads = 256;   // threads of a mask block
constexpr int kSweepThreads = 512;  // threads of a sweep block
constexpr float kEps = 1e-8f;       // ops/iou.py _EPS
constexpr int kFields = 16;         // floats of a staged box
constexpr int kPad = kBlock + 1;    // a field's stride: no bank conflicts
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kInFlight = 8;        // mask loads a sweep thread issues
// bytes of shared memory the sweep's "removed" bits may take: the 48 KB a
// block has without opting in, less 2 KB for its static arrays
// (N <= 376,832; ops/cuda/nms.py MAX_BOXES)
constexpr int kRemovedLimit = 46 * 1024;

// fields of a staged box: x, y, w, h, cos, sin, area, bounding radius,
// corners x[4], corners y[4]
enum { kX, kY, kW, kH, kC, kS, kArea, kR, kCx, kCy = kCx + 4 };

__device__ __forceinline__ void stage_box(const float* b, float (*f)[kPad],
                                          int u) {
  const float x = b[0], y = b[1], w = b[2], h = b[3];
  const float c = cosf(b[4]), s = sinf(b[4]);
  f[kX][u] = x;
  f[kY][u] = y;
  f[kW][u] = w;
  f[kH][u] = h;
  f[kC][u] = c;
  f[kS][u] = s;
  f[kArea][u] = __fmul_rn(w, h);
  // the bounding circle, only for the early out
  f[kR][u] = 0.5f * sqrtf(w * w + h * h);
  const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
  const float dx[4] = {hw, hw, -hw, -hw};
  const float dy[4] = {-hh, hh, hh, -hh};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // x + dx * cos - dy * sin, y + dx * sin + dy * cos
    f[kCx + k][u] = __fsub_rn(__fadd_rn(x, __fmul_rn(dx[k], c)),
                              __fmul_rn(dy[k], s));
    f[kCy + k][u] = __fadd_rn(__fadd_rn(y, __fmul_rn(dx[k], s)),
                              __fmul_rn(dy[k], c));
  }
}

// The point (x, y) inside box u of f, within _EPS (ops/iou.py
// _points_in_box).
__device__ __forceinline__ bool in_box(float x, float y,
                                       float (*f)[kPad], int u) {
  const float px = __fsub_rn(x, f[kX][u]), py = __fsub_rn(y, f[kY][u]);
  const float c = f[kC][u], s = f[kS][u];
  const float lx = __fadd_rn(__fmul_rn(px, c), __fmul_rn(py, s));
  const float ly = __fadd_rn(-__fmul_rn(px, s), __fmul_rn(py, c));
  return fabsf(lx) <= __fadd_rn(__fmul_rn(f[kW][u], 0.5f), kEps) &&
         fabsf(ly) <= __fadd_rn(__fmul_rn(f[kH][u], 0.5f), kEps);
}

// A sum over the warp's lanes in the butterfly's order; every lane gets
// the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

// IoU of row box a of ra and column box b of cb, by the whole warp: lane
// l holds candidate slot l (0-3: a's corners in b, 4-7: b's corners in a,
// 8 + 4 i + j: a's edge i with b's edge j, 24-31: none).
__device__ float warp_iou(float (*ra)[kPad], int a, float (*cb)[kPad],
                          int b, int lane) {
  bool has = false;
  float x = 0.f, y = 0.f;
  if (lane < 4) {
    x = ra[kCx + lane][a];
    y = ra[kCy + lane][a];
    has = in_box(x, y, cb, b);
  } else if (lane < 8) {
    x = cb[kCx + lane - 4][b];
    y = cb[kCy + lane - 4][b];
    has = in_box(x, y, ra, a);
  } else if (lane < 24) {
    const int i = (lane - 8) >> 2, j = (lane - 8) & 3;
    const float ax = ra[kCx + i][a], ay = ra[kCy + i][a];
    const float bx = cb[kCx + j][b], by = cb[kCy + j][b];
    const float d1x = __fsub_rn(ra[kCx + ((i + 1) & 3)][a], ax);
    const float d1y = __fsub_rn(ra[kCy + ((i + 1) & 3)][a], ay);
    const float d2x = __fsub_rn(cb[kCx + ((j + 1) & 3)][b], bx);
    const float d2y = __fsub_rn(cb[kCy + ((j + 1) & 3)][b], by);
    const float den = __fsub_rn(__fmul_rn(d1x, d2y), __fmul_rn(d1y, d2x));
    const float ex = __fsub_rn(bx, ax), ey = __fsub_rn(by, ay);
    const float tn = __fsub_rn(__fmul_rn(ex, d2y), __fmul_rn(ey, d2x));
    const float sn = __fsub_rn(__fmul_rn(ex, d1y), __fmul_rn(ey, d1x));
    const bool nz = fabsf(den) > kEps;
    const float ds = nz ? den : 1.0f;
    const float tt = __fdiv_rn(tn, ds), ss = __fdiv_rn(sn, ds);
    // 1 + _EPS rounds to 1 in float32
    has = nz && tt >= -kEps && tt <= 1.0f && ss >= -kEps && ss <= 1.0f;
    x = __fadd_rn(ax, __fmul_rn(tt, d1x));
    y = __fadd_rn(ay, __fmul_rn(tt, d1y));
  }
  const int cnt = __popc(__ballot_sync(kAll, has));
  if (cnt < 3) return 0.f;
  const float cenx = __fdiv_rn(warp_sum(has ? x : 0.f), (float)cnt);
  const float ceny = __fdiv_rn(warp_sum(has ? y : 0.f), (float)cnt);
  // ops/iou.py puts the slots without a candidate last, at angle 1e9
  float ang = has ? atan2f(__fsub_rn(y, ceny), __fsub_rn(x, cenx)) : 1e9f;
  int slot = lane;
  // bitonic sort of (angle, slot) over the lanes, ascending: equal
  // angles keep their slot order
#pragma unroll
  for (int k = 2; k <= 32; k *= 2) {
#pragma unroll
    for (int j = k / 2; j > 0; j /= 2) {
      const float oa = __shfl_xor_sync(kAll, ang, j);
      const int os = __shfl_xor_sync(kAll, slot, j);
      const bool less = oa < ang || (oa == ang && os < slot);
      // the lower lane of an ascending pair keeps the smaller key
      if (less == (((lane & j) == 0) == ((lane & k) == 0))) {
        ang = oa;
        slot = os;
      }
    }
  }
  const float px = __shfl_sync(kAll, x, slot), py = __shfl_sync(kAll, y, slot);
  const int q = lane + 1 < cnt ? lane + 1 : 0;  // the polygon closes
  const float nx = __shfl_sync(kAll, px, q), ny = __shfl_sync(kAll, py, q);
  const float cross = lane < cnt ? __fsub_rn(__fmul_rn(px, ny),
                                             __fmul_rn(nx, py))
                                 : 0.f;
  const float inter = __fmul_rn(0.5f, fabsf(warp_sum(cross)));
  const float uni = __fsub_rn(__fadd_rn(ra[kArea][a], cb[kArea][b]), inter);
  return __fdiv_rn(inter, fmaxf(uni, kEps));
}

// (row block, column block) of tile t of a row's upper triangle of
// words x words tiles, row by row.
__device__ __forceinline__ void tile_of(int t, int words, int& rb,
                                        int& cb) {
  const double w2 = 2.0 * words + 1.0;
  int r = (int)((w2 - sqrt(w2 * w2 - 8.0 * t)) / 2.0);
  auto start = [&](int q) { return q * words - q * (q - 1) / 2; };
  r = max(0, min(r, words - 1));
  while (r > 0 && start(r) > t) --r;
  while (r + 1 < words && start(r + 1) <= t) ++r;
  rb = r;
  cb = r + (t - start(r));
}

__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const unsigned char* __restrict__ valid, int n,
                    int words, float thr,
                    unsigned long long* __restrict__ mask) {
  __shared__ float rowf[kFields][kPad], colf[kFields][kPad];
  __shared__ bool row_ok[kBlock], col_ok[kBlock];
  __shared__ unsigned short pairs[kBlock * kBlock];
  __shared__ unsigned long long bits[kBlock], cols[kBlock];
  __shared__ int npairs;
  int rb, cb;
  tile_of(blockIdx.x, words, rb, cb);
  const long long r = blockIdx.y;
  const float* bx = boxes + r * n * 5;
  const unsigned char* vd = valid + r * n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = rb * kBlock, j0 = cb * kBlock;
  if (tid == 0) npairs = 0;
  if (tid < 2 * kBlock) {
    const bool col = tid >= kBlock;
    const int u = tid % kBlock, k = (col ? j0 : i0) + u;
    bool ok = false;
    if (k < n) {
      stage_box(bx + (long long)k * 5, col ? colf : rowf, u);
      ok = vd[k] != 0;
    }
    (col ? col_ok : row_ok)[u] = ok;
  }
  if (tid < kBlock) bits[tid] = cols[tid] = 0ull;
  __syncthreads();
  // the pairs whose bounding circles meet (every valid pair where no
  // IoU can be at or below the threshold), compacted
  for (int p = tid; p < kBlock * kBlock; p += kMaskThreads) {
    const int a = p / kBlock, b = p % kBlock;
    bool near = row_ok[a] && col_ok[b] && (cb != rb || b > a);
    if (near && !(thr < 0.f)) {
      const float dx = colf[kX][b] - rowf[kX][a];
      const float dy = colf[kY][b] - rowf[kY][a];
      const float reach =
          rowf[kR][a] + colf[kR][b] + 1e-3f +
          1e-5f * (fabsf(rowf[kX][a]) + fabsf(rowf[kY][a]) +
                   fabsf(colf[kX][b]) + fabsf(colf[kY][b]));
      near = !(dx * dx + dy * dy > reach * reach);
    }
    const unsigned vote = __ballot_sync(kAll, near);
    int at = 0;
    if (lane == 0 && vote) at = atomicAdd(&npairs, __popc(vote));
    at = __shfl_sync(kAll, at, 0);
    if (near)
      pairs[at + __popc(vote & ((1u << lane) - 1u))] = (unsigned short)p;
  }
  __syncthreads();
  const int listed = npairs;
  for (int e = warp; e < listed; e += kMaskThreads / 32) {
    const int p = pairs[e], a = p / kBlock, b = p % kBlock;
    const float iou = warp_iou(rowf, a, colf, b, lane);
    if (lane == 0 && iou > thr) {
      atomicOr(&bits[a], 1ull << b);
      if (cb == rb) atomicOr(&cols[b], 1ull << a);
    }
  }
  __syncthreads();
  const int stride = words + 1;
  if (tid < kBlock && i0 + tid < n) {
    mask[(r * n + i0 + tid) * stride + cb] = bits[tid];
    if (cb == rb) mask[(r * n + i0 + tid) * stride + words] = cols[tid];
  }
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ valid, int n,
                     int words, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned char kept_list[kBlock];
  __shared__ unsigned long long kept_word;
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kSweepThreads / 32;
  const int stride = words + 1;
  const unsigned long long* m = mask + r * n * stride;
  const unsigned char* vd = valid + r * n;
  unsigned char* kp = keep + r * n;
  // invalid boxes (and the slots past N) start removed: a warp a word,
  // its two halves by ballot
  for (int w = warp; w < words; w += kWarps) {
    const int j = w * kBlock + lane;
    const unsigned lo = __ballot_sync(kAll, j >= n || !vd[j]);
    const unsigned hi = __ballot_sync(kAll, j + 32 >= n || !vd[j + 32]);
    if (lane == 0) removed[w] = lo | (unsigned long long)hi << 32;
  }
  // warp 0: the column words of boxes base + lane and base + 32 + lane
  auto column = [&](int j) {
    return j < n ? m[(long long)j * stride + words] : 0ull;
  };
  unsigned long long col_lo = 0ull, col_hi = 0ull;
  if (warp == 0) {
    col_lo = column(lane);
    col_hi = column(lane + 32);
  }
  __syncthreads();
  for (int w = 0; w < words; ++w) {
    const int base = w * kBlock;
    if (warp == 0) {
      // the next block's column words, loaded while this one settles
      const int next = base + kBlock + lane;
      const unsigned long long nlo = w + 1 < words ? column(next) : 0ull;
      const unsigned long long nhi = w + 1 < words ? column(next + 32) : 0ull;
      // greedy NMS within the block: keep j when it is a candidate and no
      // kept i < j suppresses it. Iterated from "every candidate kept",
      // round t settles the first t boxes, and a fixed point is the one
      // solution: a few rounds (the longest suppression chain, plus one)
      const unsigned long long cand = ~removed[w];
      unsigned long long kept = cand;
      for (int round = 0; round <= kBlock; ++round) {
        const unsigned lo = __ballot_sync(kAll, !(col_lo & kept));
        const unsigned hi = __ballot_sync(kAll, !(col_hi & kept));
        const unsigned long long again =
            cand & (lo | (unsigned long long)hi << 32);
        if (again == kept) break;
        kept = again;
      }
      // the kept boxes' positions, in order
      const unsigned below = (1u << lane) - 1u;
      const unsigned klo = (unsigned)kept, khi = (unsigned)(kept >> 32);
      if ((klo >> lane) & 1u) kept_list[__popc(klo & below)] = lane;
      if ((khi >> lane) & 1u)
        kept_list[__popc(klo) + __popc(khi & below)] = lane + 32;
      if (lane == 0) kept_word = kept;
      col_lo = nlo;
      col_hi = nhi;
    }
    __syncthreads();
    const unsigned long long kept = kept_word;
    const int nk = __popcll(kept);
    if (tid < kBlock && base + tid < n) kp[base + tid] = (kept >> tid) & 1ull;
    // the kept boxes' words of every later block: (kept box, word) pairs
    // over the threads, kInFlight loads a thread issued before their ORs
    const int later = words - w - 1, pairs = nk * later;
    for (int p0 = tid; p0 < pairs; p0 += kSweepThreads * kInFlight) {
      unsigned long long got[kInFlight];
      int at[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int p = p0 + u * kSweepThreads;
        at[u] = -1;
        if (p < pairs) {
          at[u] = w + 1 + p % later;
          got[u] = m[(long long)(base + kept_list[p / later]) * stride +
                     at[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (at[u] >= 0 && got[u]) atomicOr(&removed[at[u]], got[u]);
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [R, N, 5] float32 (x, y, w, h, angle) in score order, valid [R, N]
// bool; keep [R, N] bool is written in score order; mask [R, N,
// ceil(N / 64) + 1] uint64 is scratch the kernels fill and read (a row
// box's words of the blocks from its own on, then its column word of its
// own block: the earlier boxes there that suppress it). thr: the IoU
// above which a kept box suppresses a later one. stages: 1 the mask
// kernel, 2 the sweep (on a mask an earlier call filled), 3 both.
extern "C" int nms_bev_launch(const float* boxes, const unsigned char* valid,
                              unsigned long long* mask, unsigned char* keep,
                              int r, int n, float thr, int stages,
                              void* stream) {
  if (r < 1 || r > 65535 || n < 1 || stages < 1 || stages > 3)
    return cudaErrorInvalidValue;
  const int words = (n + kBlock - 1) / kBlock;
  const size_t shared = (size_t)words * sizeof(unsigned long long);
  if (shared > kRemovedLimit) return cudaErrorInvalidValue;
  const int tiles = words * (words + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages & 1) {
    nms_mask_kernel<<<dim3(tiles, r), kMaskThreads, 0, st>>>(
        boxes, valid, n, words, thr, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    nms_sweep_kernel<<<r, kSweepThreads, shared, st>>>(mask, valid, n, words,
                                                        keep);
    return cudaGetLastError();
  }
  return cudaSuccess;
}
