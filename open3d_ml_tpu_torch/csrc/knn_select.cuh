// The k-best selection that knn_exact.cu and bucket_knn.cu share.
//
// Both kernels keep, per query, the K best (d2, index) candidates in
// registers, ascending by d2 with the lower index first among equal d2.
// What costs is the insertion: a thread that keeps its list sorted by a
// chain of compare-swaps spends ~80 instructions on every candidate that
// enters, and its warp spends them whenever any lane's candidate enters.
// Four devices cut that cost:
//
// * Hit masks. A thread computes the distances of a batch of 32 candidates
//   without a branch and only sets one bit per candidate that beats its
//   threshold. Then each lane walks its own bits, recomputing a hit's
//   distance (bit for bit the same) before it inserts. A warp runs that
//   loop as often as its busiest lane has hits in the batch, not once for
//   every candidate that any lane takes.
// * A branch-free insert. Every slot of the list decides from the old list
//   at once whether it keeps its entry, takes the new one or takes its
//   upper neighbour's, so an insert has no chain of dependent steps.
// * A seeded start. An empty list takes a slice's first K candidates as
//   they come and sorts them with one network, where K inserts would each
//   cost a whole insert.
// * Merges by key. Where one query's candidates are split into slices
//   (warps of a block, or blocks), each slice keeps its own list and the
//   lists are merged by the full (d2, index) key, so a d2 tie goes to the
//   lower index whichever slice saw it. Two sorted lists merge bitonically:
//   the elementwise minimum of one list and the other reversed holds their
//   K best as a bitonic sequence, which log2(K) half-cleaner stages sort.
//   Inside a block the warps' lists meet in shared memory in a tree.
//   Across blocks the call still takes one launch: each block posts its
//   lists to global memory and takes a ticket of its query group, and the
//   block that takes the group's last ticket merges the posted lists.
//
// Inside one slice candidates arrive in index order, so the insert needs
// no index compare: a new candidate goes after every entry of equal d2.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn_select {
namespace {

constexpr int kBatch = 32;  // candidates per hit mask, one bit each

// (da, ia) before (db, ib): ascending d2, then ascending index
__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The least float above t >= 0 (+inf stays): x <= t exactly when
// x < next_up(t), so one strict compare serves both kinds of threshold.
__device__ __forceinline__ float next_up(float t) {
  return t < CUDART_INF_F ? __int_as_float(__float_as_int(t) + 1) : t;
}

// The bits of the first m (1..32) candidates of a batch.
__device__ __forceinline__ unsigned batch_bits(int m) {
  return m >= kBatch ? 0xFFFFFFFFu : (1u << m) - 1u;
}

template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = CUDART_INF_F;
      i[j] = 0;
    }
  }

  // Insert (x, xi), x < d[K - 1], after every entry of equal d2; the last
  // entry drops out. Slot j keeps its entry while x >= d[j], takes x where
  // d[j - 1] <= x < d[j], and else its upper neighbour's entry, all read
  // from the old list (slots are rewritten from the bottom up).
  __device__ __forceinline__ void insert(float x, int xi) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool above = x < d[j - 1];
      if (x < d[j]) {
        i[j] = above ? i[j - 1] : xi;
        d[j] = above ? d[j - 1] : x;
      }
    }
    if (x < d[0]) {
      d[0] = x;
      i[0] = xi;
    }
  }

  // Order the list by key: a bitonic sorting network.
  __device__ __forceinline__ void sort() {
#pragma unroll
    for (int size = 2; size <= K; size *= 2) {
#pragma unroll
      for (int s = size / 2; s > 0; s /= 2) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int l = j ^ s;
          if (l > j) {
            const bool up = (j & size) == 0;
            if (key_less(d[l], i[l], d[j], i[j]) == up) swap(j, l);
          }
        }
      }
    }
  }

  // Start an empty list from a slice's first ``count`` (<= K) candidates,
  // (dist(j), base + j), sorted by key: one network where inserting them
  // one by one would run the insert K times.
  template <class Dist>
  __device__ __forceinline__ void seed(int count, int base, Dist dist) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < count) {
        d[j] = dist(j);
        i[j] = base + j;
      }
    }
    sort();
  }

  // Keep the K best by key of this list and (od, oi), both ascending by key.
  __device__ __forceinline__ void merge(const float (&od)[K],
                                        const int (&oi)[K]) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (key_less(od[K - 1 - j], oi[K - 1 - j], d[j], i[j])) {
        d[j] = od[K - 1 - j];
        i[j] = oi[K - 1 - j];
      }
    }
#pragma unroll
    for (int s = K / 2; s > 0; s /= 2) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if ((j & s) == 0 && key_less(d[j + s], i[j + s], d[j], i[j]))
          swap(j, j + s);
      }
    }
  }

  __device__ __forceinline__ void swap(int a, int b) {
    const float td = d[a];
    d[a] = d[b];
    d[b] = td;
    const int ti = i[a];
    i[a] = i[b];
    i[b] = ti;
  }

  // The list in shared or global memory, entry j at [j * stride].
  __device__ __forceinline__ void store(float* sd, int* si, int stride) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sd[j * stride] = d[j];
      si[j * stride] = i[j];
    }
  }

  __device__ __forceinline__ void merge_from(const float* sd, const int* si,
                                             int stride) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      od[j] = sd[j * stride];
      oi[j] = si[j * stride];
    }
    merge(od, oi);
  }

  // Merge in a list that another block posted to global memory (entry j at
  // [j]), read through L2: an SM's L1 does not see other SMs' writes.
  __device__ __forceinline__ void merge_posted(const float* pd,
                                               const int* pi) {
    float od[K];
    int oi[K];
    if constexpr (K % 4 == 0) {
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const float4 dv = __ldcg(reinterpret_cast<const float4*>(pd + j));
        const int4 iv = __ldcg(reinterpret_cast<const int4*>(pi + j));
        od[j] = dv.x, od[j + 1] = dv.y, od[j + 2] = dv.z, od[j + 3] = dv.w;
        oi[j] = iv.x, oi[j + 1] = iv.y, oi[j + 2] = iv.z, oi[j + 3] = iv.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        od[j] = __ldcg(pd + j);
        oi[j] = __ldcg(pi + j);
      }
    }
    merge(od, oi);
  }
};

// Walk a lane's hit bits over a batch: recompute each hit's d2 with
// dist(j) (j the candidate's place in the batch) and insert it as
// base + j if it still beats the list's last entry and ``lim`` (a bound
// shared by the query's slices, next_up'd).
template <int K, class Dist>
__device__ __forceinline__ void insert_hits(TopK<K>& top, unsigned hits,
                                            float lim, int base, Dist dist) {
  while (hits) {
    const int j = __ffs(hits) - 1;
    hits &= hits - 1;
    const float x = dist(j);
    if (x < fminf(top.d[K - 1], lim)) top.insert(x, base + j);
  }
}

// Shared memory of tree_merge for nw warps of 32 lanes with LISTS lists
// each: half the warps' lists at a time.
template <int K, int LISTS>
__host__ __device__ constexpr size_t tree_merge_bytes(int nw) {
  return (size_t)(nw / 2) * LISTS * K * 32 * (sizeof(float) + sizeof(int));
}

// Merge the lists of nw warps (a power of two), LISTS per lane, into warp
// 0's by a tree: at each level the odd warps of a pair post their lists to
// shared memory and the even ones merge them in. Every thread of the block
// must call it; smem holds tree_merge_bytes<K, LISTS>(nw) bytes.
template <int K, int LISTS>
__device__ __forceinline__ void tree_merge(TopK<K> (&top)[LISTS], void* smem,
                                           int nw, int warp, int lane) {
  float* sd = static_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sd + (nw / 2) * LISTS * K * 32);
  for (int r = 1; r < nw; r *= 2) {
    __syncthreads();  // the previous level's reads, or the caller's, done
    const int pair = warp / (2 * r);
    if (warp % (2 * r) == r) {
#pragma unroll
      for (int s = 0; s < LISTS; ++s) {
        const int at = (pair * LISTS + s) * K * 32 + lane;
        top[s].store(sd + at, si + at, 32);
      }
    }
    __syncthreads();
    if (warp % (2 * r) == 0) {
#pragma unroll
      for (int s = 0; s < LISTS; ++s) {
        const int at = (pair * LISTS + s) * K * 32 + lane;
        top[s].merge_from(sd + at, si + at, 32);
      }
    }
  }
}

// Where a plan splits each query's candidates over ``groups`` blocks:
// every thread of a block calls this after posting its lists, and every
// thread learns whether its block took the last of its query group's
// tickets, and so is the one to merge the group's posted lists. The
// ticket is 0 before the launch; the last block sets it back to 0, ready
// for the next launch on the stream.
__device__ __forceinline__ bool took_last_ticket(unsigned* ticket,
                                                 int groups) {
  __shared__ bool last;
  __threadfence();  // this thread's posted lists, seen by every block
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == (unsigned)groups - 1u;
    if (last) atomicExch(ticket, 0u);
  }
  __syncthreads();
  return last;
}

}  // namespace
}  // namespace knn_select
