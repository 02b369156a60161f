// Device code shared by the stencil kernels (stencil_conv.cu and
// stencil_match.cu): one query block's candidate table of Morton keys in
// shared memory, sorted, and the lookup of tap keys in it.
//
// It replaces the table lookup of the TPU kernels in
// open3d_ml_tpu/ops/pallas/stencil.py (_match_kernel and _conv_kernel),
// which compared every tap key with every table key on the vector unit.
// On the H100 the lookup is bound by shared-memory reads, not by memory:
// the table comes from L2 in one trip, then each search reads ~10 keys,
// and for a level-0 block of the ScanNet config the searches are most of
// the lookup (clock64 stamps per phase, a one-off probe).
//
// The table of query block i is the S segments seg_ids[b, i] of seg rows
// each, in that order; table position p is row p % seg of slot p / seg.
// The slots are ranked by distance, not by id.
//
// Precondition (the callers' wrappers state it): the keys of each batch row
// ascend, pad keys INT32_MAX at the end, as sort_sites and
// bucket_downsample leave them. A segment is a run of seg consecutive rows,
// so segments with larger ids hold larger keys, and the table's segments
// copied in the order of their ids form one sorted array. Ordering S ids
// replaces sorting S * seg keys: each slot's rank is the number of ids
// below its own, counted by one lane per slot (for S <= 32 in one warp's
// registers, else in shared memory). A slot that repeats the
// id of a lower slot is dropped first (its keys twice would break the
// order; the lower slot wins among equal keys anyway); all-pad segments
// have the largest ids and sort last. Each tap is then resolved by one
// binary search over the whole table (10 steps at 1,024 keys) instead of
// a range check of every segment and a search of each that may hold it.
//
// Keys that do not ascend give wrong matches but no access out of bounds:
// a search ends inside [0, S * seg].

#pragma once

#include <cuda_runtime.h>

namespace stencil {

constexpr int kBigPos = 0x7F000000;  // a miss: past any table position

// Shared-memory layout of one table: key_s[S * seg] sorted keys, then
// sid_s[S] the slots' segment ids (-1 for a slot that repeats the id of a
// lower one), slot_of[S] the slot of each sorted segment, and count, the
// number of sorted segments. (Bytes: table_bytes.)
struct Table {
  int* key_s;
  int* sid_s;
  int* slot_of;
  int* count;
};

__host__ __device__ constexpr size_t table_bytes(int s, int seg) {
  return sizeof(int) * ((size_t)s * seg + 2 * (size_t)s + 1);
}

// table_bytes rounded up to 16, for tables laid out one after another
__host__ __device__ constexpr size_t table_stride(int s, int seg) {
  return (table_bytes(s, seg) + 15) / 16 * 16;
}

__device__ __forceinline__ Table table_at(void* base, int s, int seg) {
  int* p = static_cast<int*>(base);
  return {p, p + s * seg, p + s * seg + s, p + s * seg + 2 * s};
}

// Order the slots of ntab tables (table(i) gives the i-th) whose ids are in
// their sid_s, those of need's bits: a slot that repeats the id of a lower
// one is dropped (its sid_s becomes -1; the lower slot holds the same keys
// and wins among equal ones), and the others go to slot_of in the order of
// their ids, count of them. Every thread of the block calls it after the
// ids are written and a barrier; it synchronises before it returns.
template <typename TableOf>
__device__ __forceinline__ void order_tables(TableOf table, int ntab,
                                             unsigned need, int s) {
  for (int u = threadIdx.x; u < ntab * s; u += blockDim.x) {
    const int tb = u / s, i = u - tb * s;
    if (!((need >> tb) & 1u)) continue;
    const Table t = table(tb);
    bool repeats = false;
    for (int j = 0; j < i; ++j) repeats |= t.sid_s[j] == t.sid_s[i];
    t.slot_of[i] = repeats;  // a flag until the ids are marked
    if (i == 0) *t.count = 0;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < ntab * s; u += blockDim.x) {
    const int tb = u / s, i = u - tb * s;
    if ((need >> tb) & 1u && table(tb).slot_of[i]) table(tb).sid_s[i] = -1;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < ntab * s; u += blockDim.x) {
    const int tb = u / s, i = u - tb * s;
    if (!((need >> tb) & 1u)) continue;
    const Table t = table(tb);
    const int id = t.sid_s[i];
    if (id < 0) continue;
    int rank = 0;
    for (int j = 0; j < s; ++j) rank += (unsigned)t.sid_s[j] < (unsigned)id;
    t.slot_of[rank] = i;
    atomicAdd(t.count, 1);
  }
  __syncthreads();
}

// order_tables for one table of S <= 32 slots, by one warp in registers:
// lane i holds slot i's id (anything for i >= s). A repeat is found by
// __match_any_sync, a rank by 32 shuffles; no shared-memory round trip and
// no barrier. rank_of, where given, gets each slot's sorted place (-1 for
// a repeat). The caller synchronises before the table is read.
__device__ __forceinline__ void order_slots_warp(const Table& t, int id,
                                                 int s,
                                                 int* rank_of = nullptr) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < s;
  const unsigned same = __match_any_sync(0xffffffffu, in ? id : -1 - lane);
  const bool live = in && !(same & ((1u << lane) - 1u));
  const unsigned mine = live ? (unsigned)id : 0xffffffffu;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    rank += __shfl_sync(0xffffffffu, mine, j) < mine;
  const unsigned lives = __ballot_sync(0xffffffffu, live);
  if (in) t.sid_s[lane] = live ? id : -1;
  if (live) t.slot_of[rank] = lane;
  if (rank_of && in) rank_of[lane] = live ? rank : -1;
  if (lane == 0) *t.count = __popc(lives);
}

// Where unit u of a table's keys (4 keys where vec, else 1) comes from and
// goes to (its sorted place), once slot_of and count are known; false for
// units past the table's sorted segments.
template <int SEG>
__device__ __forceinline__ bool key_unit(const Table& t, const int* keys_b,
                                         int u, int seg_rt, bool vec,
                                         const int*& src, int*& dst) {
  const int seg = SEG ? SEG : seg_rt;
  const int per = vec ? seg / 4 : seg;  // units per segment
  const int r = u / per, c = (u - r * per) * (vec ? 4 : 1);
  if (r >= *t.count) return false;
  src = keys_b + (long long)t.sid_s[t.slot_of[r]] * seg + c;
  dst = t.key_s + r * seg + c;
  return true;
}

// Copy unit u of a table's keys into its sorted place (key_unit).
template <int SEG>
__device__ __forceinline__ void copy_keys(const Table& t, const int* keys_b,
                                          int u, int seg_rt, bool vec) {
  const int* src;
  int* dst;
  if (!key_unit<SEG>(t, keys_b, u, seg_rt, vec, src, dst)) return;
  if (vec)
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  else
    *dst = *src;
}

// Load and sort one table: its ids from sids (S of them), then its keys
// from keys_b, the batch row's [npad] keys, in the order of their ids. SEG is
// seg at compile time, or 0 to read seg_rt. vec: 16-byte loads (keys_b
// 16-byte aligned and seg a multiple of 4). Every thread of the block
// calls it; it synchronises before it returns. The table's sorted keys
// are key_s[0, *count * seg).
template <int SEG>
__device__ __forceinline__ void load_table(const Table& t, const int* keys_b,
                                           const int* sids, int s,
                                           int seg_rt, bool vec) {
  const int seg = SEG ? SEG : seg_rt;
  if (s <= 32) {
    if (threadIdx.x < 32)
      order_slots_warp(t, threadIdx.x < s ? sids[threadIdx.x] : 0, s);
    __syncthreads();
  } else {
    for (int i = threadIdx.x; i < s; i += blockDim.x) t.sid_s[i] = sids[i];
    __syncthreads();
    order_tables([&](int) { return t; }, 1, 1u, s);
  }
  const int units = s * (vec ? seg / 4 : seg);
  for (int u = threadIdx.x; u < units; u += blockDim.x)
    copy_keys<SEG>(t, keys_b, u, seg, vec);
  __syncthreads();
}

// pos[i] = the number of the n sorted keys below key[i] (the first
// position whose key is >= key[i]), for NT keys at once so that their
// dependent shared-memory reads overlap.
template <int NT>
__device__ __forceinline__ void lower_bounds(const int* key_s, int n,
                                             const int (&key)[NT],
                                             int (&pos)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) pos[i] = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int p = pos[i] + step;
      if (p <= n && key_s[p - 1] < key[i]) pos[i] = p;
    }
  }
}

// Whether the search for key ended on a match: pos < n and key_s[pos] ==
// key, for a tap key (misses, key < 0, never match).
__device__ __forceinline__ bool matched(const int* key_s, int n, int pos,
                                        int key) {
  return key >= 0 && pos < n && key_s[pos] == key;
}

// The value row of a match at sorted position pos; shift, where >= 0, is
// log2 of a run-time seg that is a power of two.
template <int SEG>
__device__ __forceinline__ int value_row(const Table& t, int pos, int seg_rt,
                                         int shift = -1) {
  const int seg = SEG ? SEG : seg_rt;
  const int r = SEG || shift < 0 ? pos / seg : pos >> shift;
  return t.sid_s[t.slot_of[r]] * seg + (pos - r * seg);
}

// The least table position holding key, given its first match at sorted
// position pos. Later sorted segments can hold the key only at their row 0
// (the table ascends); that happens only where keys repeat across
// segments (the INT32_MAX pads), never for a valid key.
template <int SEG>
__device__ __forceinline__ int table_pos(const Table& t, int pos, int key,
                                         int seg_rt) {
  const int seg = SEG ? SEG : seg_rt;
  const int r = pos / seg;
  int best = t.slot_of[r] * seg + (pos - r * seg);
  for (int r2 = r + 1; r2 < *t.count && t.key_s[r2 * seg] == key; ++r2)
    best = min(best, t.slot_of[r2] * seg);
  return best;
}

}  // namespace stencil
