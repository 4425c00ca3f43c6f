// The window search over a sorted id stream, shared by K5
// (scatter_unique_sorted.cu) and K7 (sparse_adamw.cu): a block that owns a
// tile of table rows finds where the tile's entries start and end in the
// ascending stream.
#pragma once

namespace {

// first j in [0, n) with a[j] >= key (n if none), by one whole warp: each
// step its 32 lanes probe 32 points of the remaining range, which shrinks
// about 33-fold (about 4 dependent loads over a million entries, where a
// per-row binary search would cost 20 per row)
__device__ long long warp_lower_bound(const int* __restrict__ a, long long n,
                                      long long key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // a[j] < key for j < lo, a[j] >= key for j >= hi
  while (lo < hi) {
    const long long d = hi - lo;
    const long long p = lo + d * (lane + 1) / 33;  // in [lo, hi)
    // the probes ascend, so the lanes whose probe is below key are a prefix
    const int c = __popc(__ballot_sync(0xffffffffu, __ldg(a + p) < key));
    const long long new_lo = c > 0 ? lo + d * c / 33 + 1 : lo;
    if (c < 32) hi = lo + d * (c + 1) / 33;
    lo = new_lo;
  }
  return lo;
}

}  // namespace
