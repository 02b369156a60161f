// Device code shared by the stencil kernels (stencil_conv.cu and
// stencil_match.cu): one query block's candidate table of Morton keys in
// shared memory, and the lookup of a tap key in it.
//
// The table of query block i is the S segments seg_ids[b, i] of seg rows
// each, in that order; table position p is row p % seg of slot p / seg.
// Keys ascend within each segment (the sites are Morton-sorted and pad keys
// are INT32_MAX at the end), so a tap is resolved by a range check and a
// binary search per segment.

#pragma once

namespace stencil {

// Copy the keys of one table into key_s[S * seg]; keys_b is the batch
// row's [npad] keys, sids its block's S slot ids. The caller synchronises.
__device__ __forceinline__ void load_table(int* key_s, const int* keys_b,
                                           const int* sids, int s, int seg) {
  for (int t = threadIdx.x; t < s * seg; t += blockDim.x)
    key_s[t] = keys_b[(long long)sids[t / seg] * seg + t % seg];
}

// The least table position whose key equals key, or -1: misses (key < 0)
// and keys that no row of the table holds.
__device__ __forceinline__ int find_tap(const int* key_s, int s, int seg,
                                        int key) {
  if (key < 0) return -1;
  for (int si = 0; si < s; ++si) {
    const int* sk = key_s + si * seg;
    if (key < sk[0] || key > sk[seg - 1]) continue;
    int lo = 0, hi = seg - 1;  // first position with sk[pos] >= key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sk[mid] < key) lo = mid + 1; else hi = mid;
    }
    if (sk[lo] == key) return si * seg + lo;
  }
  return -1;
}

}  // namespace stencil
