// K1: one-pass AdamW with decoupled weight decay over a list of leaves, each
// leaf's p / mu / nu updated in place:
//   mu  = b1 * mu + (1 - b1) * g
//   nu  = b2 * nu + (1 - b2) * g * g
//   upd = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
//   p   = p - lr * upd
// with bc = 1 - b^t computed on the host in float32 (optax.adamw's algebra,
// eps_root = 0) and wd the leaf's own (0 for a leaf without decay). lr, b1,
// b2, eps, bc1 and bc2 are read on the card from the step's row of the
// optimizer's scalar buffer (step_scalars.cuh), so that a CUDA graph that
// captured the launch reads each replay's values.
//
// Replaces map_tpu/ops/fused_adamw.py:fused_adamw_dense, which streams
// (512, W) tiles of one table's p, mu, nu and g through VMEM once and writes
// p, mu, nu back aliased in place. Hopper needs no tiles: the pass is
// elementwise. What bounds it here is a training step's shape: one table of
// 16 M elements and 16 leaves of 1 to 400 k, each launched alone paying a
// launch and a tail that take longer than its bytes. So one launch takes
// all of a step's leaves.
//
// Bound: device-memory bytes. 4 arrays read and 3 written, 28 bytes per
// element against about 14 operations, far below the card's 295 operations
// per byte. A canonical DCNv2 step's leaves (about 19 M elements) move about
// 533 MB, or about 0.16 ms at 3.35 TB/s.
//
// Design. The descriptor block (`Leaves`, at most 4 KB) is the kernel's
// parameter, passed by value: the address of the step's scalars, and for each
// leaf its pointers, size, wd, 16-byte alignment and first unit. A unit is 4
// consecutive elements of one leaf, one 16-byte vector; the leaves' units
// lie end to end in one flat space, laid out by the plan in
// map_tpu_torch/ops/fused_adamw.py:plan. Block b takes units
// [b * kThreads * kUnits, (b + 1) * kThreads * kUnits); its thread t takes
// the kUnits units t, t + kThreads, ... of that range, finds each one's leaf
// (a binary search for the first, then a walk forward, over the first units
// copied into shared memory), and issues every load of all its units before
// any arithmetic, so that 4 arrays x kUnits vectors a thread are in flight,
// at 4 blocks an SM. (Streaming hints, ld/st.global.cs, and 4 or 8 units a
// thread measured slower on the H100: PERF.md.) A unit of an
// unaligned leaf, or the last partial unit of a leaf, goes element by
// element in the same launch.
//
// Rounding: the arithmetic is adamw_math.cuh's, shared with K7: every
// operation rounds on its own, in the order above, as the plain PyTorch
// version (map_tpu_torch/ops/fused_adamw.py fused_adamw_plain) and XLA's
// elementwise ops do; kernel and plain version agree bit for bit.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "step_scalars.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 2;  // units a thread: 16-byte vectors of each array in flight
constexpr int kMaxLeaves = 64;

// ops/fused_adamw.py LEAF_DTYPE
struct Leaf {
  float* p;
  float* mu;
  float* nu;
  const float* g;
  long long numel;
  long long start;  // first unit in the launch's flat space
  float wd;
  int aligned;      // p, mu, nu and g all 16-byte aligned
};
static_assert(sizeof(Leaf) == 56, "Leaf must match ops/fused_adamw.py LEAF_DTYPE");
static_assert(offsetof(Leaf, start) == 40 && offsetof(Leaf, wd) == 48,
              "Leaf must match ops/fused_adamw.py LEAF_DTYPE");

struct Leaves {
  const float* scal;  // the step's row: [lr, wd (unused: each leaf has its own), b1, ...]
  int count;
  long long units;
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Leaves) <= 4096, "the descriptor block is a kernel parameter");

__device__ __forceinline__ void adamw4(float4& p, float4& m, float4& v, const float4 g,
                                       const Scalars& s) {
  adamw_elem(p.x, m.x, v.x, g.x, s);
  adamw_elem(p.y, m.y, v.y, g.y, s);
  adamw_elem(p.z, m.z, v.z, g.z, s);
  adamw_elem(p.w, m.w, v.w, g.w, s);
}

__global__ void __launch_bounds__(kThreads, 4)
adamw_leaves(const __grid_constant__ Leaves L) {
  __shared__ long long first[kMaxLeaves];
  for (int i = threadIdx.x; i < L.count; i += kThreads) first[i] = L.leaf[i].start;
  const Scalars common = load_scalars(L.scal, 0.f);
  __syncthreads();

  const long long u0 = static_cast<long long>(blockIdx.x) * kThreads * kUnits + threadIdx.x;
  int leaf[kUnits];
  long long e0[kUnits];
  bool vec[kUnits];
  float4 pv[kUnits], mv[kUnits], vv[kUnits], gv[kUnits];
  int li = 0;
  if (u0 < L.units) {  // the last leaf whose first unit is <= u0
    int hi = L.count - 1;
    while (li < hi) {
      const int mid = (li + hi + 1) >> 1;
      if (first[mid] <= u0) li = mid; else hi = mid - 1;
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long u = u0 + static_cast<long long>(k) * kThreads;
    leaf[k] = -1;
    vec[k] = false;
    if (u < L.units) {
      while (li + 1 < L.count && first[li + 1] <= u) ++li;
      const Leaf& f = L.leaf[li];
      leaf[k] = li;
      e0[k] = (u - first[li]) * 4;
      vec[k] = f.aligned && e0[k] + 4 <= f.numel;
      if (vec[k]) {
        pv[k] = *reinterpret_cast<const float4*>(f.p + e0[k]);
        mv[k] = *reinterpret_cast<const float4*>(f.mu + e0[k]);
        vv[k] = *reinterpret_cast<const float4*>(f.nu + e0[k]);
        gv[k] = __ldg(reinterpret_cast<const float4*>(f.g + e0[k]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    if (leaf[k] < 0) continue;
    const Leaf& f = L.leaf[leaf[k]];
    Scalars s = common;
    s.wd = f.wd;
    if (vec[k]) {
      adamw4(pv[k], mv[k], vv[k], gv[k], s);
      *reinterpret_cast<float4*>(f.p + e0[k]) = pv[k];
      *reinterpret_cast<float4*>(f.mu + e0[k]) = mv[k];
      *reinterpret_cast<float4*>(f.nu + e0[k]) = vv[k];
    } else {
      const long long end = e0[k] + 4 < f.numel ? e0[k] + 4 : f.numel;
      for (long long i = e0[k]; i < end; ++i) {
        float p = f.p[i], m = f.mu[i], v = f.nu[i];
        adamw_elem(p, m, v, f.g[i], s);
        f.p[i] = p;
        f.mu[i] = m;
        f.nu[i] = v;
      }
    }
  }
}

}  // namespace

// One launch over `count` leaves: `leaves` points to `count` host records of
// ops/fused_adamw.py LEAF_DTYPE (copied before the call returns), laid out by
// its plan: the first leaf at unit 0, each next one where the one before
// ends, `units` in all, `blocks` of kThreads * kUnits units. `scal` is the
// optimizer's (slots, 8) float32 scalar buffer on the card and `slot` the
// step's row; its scalars but wd are the leaves' common ones.
extern "C" int map_tpu_fused_adamw_leaves(const void* leaves, int count, long long units,
                                          int blocks, const void* scal, int slot,
                                          void* stream) {
  if (count < 1 || count > kMaxLeaves || units < 1 || blocks < 1 || scal == nullptr ||
      slot < 0 || static_cast<long long>(blocks) * kThreads * kUnits < units)
    return static_cast<int>(cudaErrorInvalidValue);
  Leaves L;
  memset(&L, 0, sizeof(L));
  L.scal = static_cast<const float*>(scal) + static_cast<long long>(slot) * kScalarWidth;
  L.count = count;
  L.units = units;
  memcpy(L.leaf, leaves, sizeof(Leaf) * count);
  long long next = 0;
  for (int i = 0; i < count; ++i) {
    const Leaf& f = L.leaf[i];
    if (f.numel < 1 || f.start != next) return static_cast<int>(cudaErrorInvalidValue);
    next += (f.numel + 3) / 4;
  }
  if (next != units) return static_cast<int>(cudaErrorInvalidValue);
  adamw_leaves<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
