// K3: dense embedding-gradient scatter-add,
//   out[v, :] = sum of grads[i, :] over every i with ids[i] == v   (f32)
// for a (V, E) table, from (N, E) row gradients in f32 or bf16. The wrapper
// (map_tpu_torch/ops/scatter.py) sorts the flat ids first (torch.sort,
// stable) and hands over the sorted ids and the permutation.
//
// Replaces map_tpu/ops/pallas_scatter.py:_scatter_add_pallas. The TPU kernel
// builds a (chunk, tile) pair list and folds duplicates with one-hot matmuls
// on the MXU because the TPU has no fast scattered writes; none of that
// carries over. Here every table row is written exactly once, by the threads
// that own it: they find the row's segment of the sorted ids by binary search
// and sum its gradients in segment order, in f32, or write zeros. So the
// kernel needs no atomics and no separate memset, and its result does not
// depend on scheduling: the stable sort keeps duplicates in their original
// order, and the sum runs in that order (the order in which index_add_ on
// the CPU adds them).
//
// Bound: device-memory bytes. The dense (V, E) f32 output dominates: 64.9 MB
// at the canonical table (1,013,519 x 16), against about 3.1 MB of bf16
// gradients and 1.2 MB of ids and permutation at the training shape
// (N = 4096 x 24), about 0.021 ms at 3.35 TB/s. Design: E/4 threads per row,
// each summing and storing one float4 (16 B) of the row, a grid-stride loop
// over V * E/4; the binary search reads the 393 KB of sorted ids, which stay
// in L2. Widths that are not a multiple of 4, or unaligned tensors, take an
// element-per-thread path.
//
// Ids must lie in [0, V): the kernel does not check them (an id outside is
// summed into no row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* g, long long off) {
  return __ldg(reinterpret_cast<const float4*>(g + off));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* g, long long off) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(g + off));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// first position j in sorted[0, n) with sorted[j] >= row
__device__ __forceinline__ long long lower_bound(const int* __restrict__ sorted,
                                                 long long n, long long row) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(sorted + mid) < row) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
scatter_rows_vec4(const int* __restrict__ sorted, const long long* __restrict__ perm,
                  const G* __restrict__ grads, float* __restrict__ out,
                  long long n, long long vocab, int e) {
  const int groups = e >> 2;  // threads per row
  const long long items = vocab * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const long long row = i / groups;
    const int c = static_cast<int>(i - row * groups);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long j = lower_bound(sorted, n, row); j < n && __ldg(sorted + j) == row; ++j) {
      const float4 v = load4(grads, __ldg(perm + j) * e + 4 * c);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
scatter_rows_scalar(const int* __restrict__ sorted, const long long* __restrict__ perm,
                    const G* __restrict__ grads, float* __restrict__ out,
                    long long n, long long vocab, int e) {
  const long long items = vocab * e;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const long long row = i / e;
    const int c = static_cast<int>(i - row * e);
    float acc = 0.f;
    for (long long j = lower_bound(sorted, n, row); j < n && __ldg(sorted + j) == row; ++j) {
      acc = __fadd_rn(acc, to_f32(grads[__ldg(perm + j) * e + c]));
    }
    out[i] = acc;
  }
}

template <typename G>
void launch(const int* sorted, const long long* perm, const G* grads, float* out,
            long long n, long long vocab, int e, bool vec, cudaStream_t s) {
  const long long items = vec ? vocab * (e / 4) : vocab * e;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned g = static_cast<unsigned>(blocks);
  if (vec) {
    scatter_rows_vec4<G><<<g, kThreads, 0, s>>>(sorted, perm, grads, out, n, vocab, e);
  } else {
    scatter_rows_scalar<G><<<g, kThreads, 0, s>>>(sorted, perm, grads, out, n, vocab, e);
  }
}

}  // namespace

// sorted_ids (n,) int32 ascending, perm (n,) int64 with
// sorted_ids[j] == ids[perm[j]], grads (n, e) f32 or bf16, out (vocab, e) f32;
// all contiguous. Every element of out is written.
extern "C" int map_tpu_scatter_add(const void* sorted_ids, const void* perm,
                                   const void* grads, void* out, long long n,
                                   long long vocab, int e, int grads_bf16,
                                   void* stream) {
  if (vocab <= 0 || e <= 0) return static_cast<int>(cudaGetLastError());
  const int grad_bytes = grads_bf16 ? 8 : 16;  // bytes of 4 elements
  const bool vec = e % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grads) % grad_bytes == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sorted = static_cast<const int*>(sorted_ids);
  const long long* pm = static_cast<const long long*>(perm);
  float* o = static_cast<float*>(out);
  if (grads_bf16) {
    launch(sorted, pm, static_cast<const __nv_bfloat16*>(grads), o, n, vocab, e, vec, s);
  } else {
    launch(sorted, pm, static_cast<const float*>(grads), o, n, vocab, e, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
