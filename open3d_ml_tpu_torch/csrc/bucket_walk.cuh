// The thread mapping, and the bfloat16 rounding, that bucket_gather.cu
// and bucket_gather_bwd.cu share.
//
// Both kernels walk the flat [rows = B * Q * K, C] array of the gather's
// output (or of its cotangent) in memory order, and pair each of its
// entries with the entry of the same channel in the value row that output
// row reads:
//
//   value row of r = b * npad + seg_ids[b, i / qblock, v / seg] * seg
//                    + v % seg,   v = rel[r], r = (b * Q + i) * K + j
//
// A unit is one float, or one float4 where C is a multiple of 4 and the
// row-strided pointers are 16-byte aligned (the wrapper decides), so a row
// holds cu = C or C / 4 units.
//
// A warp takes a tile of up to 32 consecutive rows (fewer where rows are
// wide, so that a tile holds at most kTileUnits units, or where there are
// too few rows to give every resident warp a tile). Lane i computes a key
// for the tile's row i once (its value row, from rel and seg_ids loads and
// six 32-bit divisions); then the warp steps through the tile's units 32
// at a time, lane l taking units l, l + 32, ..., and reads each unit's
// key from its row's lane by shuffle. So every warp access to the flat
// array covers 32 consecutive units (128 or 512 bytes), whatever C is,
// and no lane idles but in a tile's last step. A lane's row and channel
// advance by a fixed step, with no division per unit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bucket {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTileUnits = 1024;

// the tables of one gather; rows and value rows stay below 2^31 (the
// wrapper checks it)
struct Tables {
  const int* seg_ids;  // [B, nqb, S]
  const int* rel;      // [B, Q, K]
  int rows, npad, q, k, nqb, s, seg, qblock;
};

__device__ __forceinline__ int value_row(const Tables& t, int r) {
  const unsigned bq = (unsigned)r / t.k;  // b * Q + i
  const unsigned i = bq % t.q;
  const unsigned b = bq / t.q;
  const unsigned v = __ldg(t.rel + r);
  const int sid = __ldg(t.seg_ids + (b * t.nqb + i / t.qblock) * t.s +
                        v / t.seg);
  return b * t.npad + sid * t.seg + v % t.seg;
}

// A value rounded to bfloat16 and widened back, channel by channel.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

// Where a lane starts in a tile of rows of cu units, and how far 32 units
// move it.
struct Steps {
  int row0, col0, drow, dcol;
  __device__ Steps(int lane, int cu)
      : row0(lane / cu), col0(lane % cu), drow(32 / cu), dcol(32 % cu) {}
};

// Steps the warp through the units of the nrows rows from r0, 32 at a
// time, calling op(o, key, col, live) on every lane at each step: o the
// lane's unit's index in the flat [rows, cu] array, col its unit in its
// row, key the value that lane i holds in `key` for row r0 + i, and live
// false where the lane has no unit in this step (the tile's last).
template <class Op>
__device__ __forceinline__ void walk_tile(long long r0, int nrows, int cu,
                                          const Steps& st, int key, Op op) {
  const int lane = threadIdx.x & 31;
  const int n = nrows * cu;
  int row = st.row0, col = st.col0;
#pragma unroll 4
  for (int base = 0; base < n; base += 32) {
    const int k = __shfl_sync(0xffffffffu, key, row & 31);
    op((r0 + row) * cu + col, k, col, base + lane < n);
    row += st.drow;
    col += st.dcol;
    if (col >= cu) {
      col -= cu;
      ++row;
    }
  }
}

// Blocks of kKernel (with `smem` bytes of dynamic shared memory) that the
// current device holds at once.
template <auto kKernel>
long long resident_blocks(int smem) {
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                    kThreads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    sms = 1;
  return (long long)sms * per_sm;
}

// Rows per warp tile for `rows` rows of cu units, where `warps` warps are
// resident: at most 32 rows and kTileUnits units, and small enough to give
// every resident warp a tile.
inline int tile_rows(int rows, int cu, long long warps) {
  long long tile = kTileUnits / cu;
  if (tile > 32) tile = 32;
  if (tile > (rows + warps - 1) / warps) tile = (rows + warps - 1) / warps;
  return tile < 1 ? 1 : (int)tile;
}

}  // namespace bucket
