// K5: dense gradient from a sorted, duplicate-free update stream,
//   out[uids[j], :] = vals[j, :]   for every j with uids[j] < V,
//   out[v, :]       = 0            for every row v no uid names,
// for uids (C,) int32 ascending and unique below V, with entries >= V
// (sentinels) after the last valid one, and vals (C, ew) f32. The ew columns
// go to two contiguous outputs, out0 (V, e0) and out1 (V, ew - e0), so the
// NCE decoder's backward gets its emb (V, 32) and bias (V, 1) gradients
// without a slice (K1 takes contiguous tensors only). Mode bf16x2 writes
// bf16(v) + bf16(v - bf16(v)) for each value v, as the TPU kernel's
// split-precision matmuls give it; the default writes v itself.
//
// Replaces map_tpu/ops/pallas_scatter.py:scatter_unique_sorted. The TPU
// kernel multiplies one-hot (512 x 512) matrices on the MXU for each 512-row
// table tile, because the TPU has no fast scattered writes; none of that
// carries over. Here each block owns a tile of kRows output rows. Two of its
// warps find where the tile's window of the stream starts and ends, each with
// one warp-wide 33-way search (sorted_stream.cuh, shared with K7). Since the
// ids are unique, at most kRows entries fall in the window: the block reads
// them once into a row -> slot map in shared memory and then writes every row
// of its tile exactly once, the value or zeros, with 16-byte stores where the
// width allows. No atomics, no memset, the result does not depend on
// scheduling. The window search reads the sentinel tail only where a probe
// lands on it; no sentinel entry is scattered.
//
// Bound: device-memory bytes. The dense output dominates: V * ew * 4 bytes
// written (133.8 MB for the decoder's 1,013,519 x 33), against the window
// entries read once, num_unique * (ew + 1) * 4 bytes; about 0.045 ms at
// 3.35 TB/s for the MFP step's stream. There is no arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // output rows per block

__device__ __forceinline__ float split_bf16x2(float v) {
  const float hi = __bfloat162float(__float2bfloat16_rn(v));
  const float lo = __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, hi)));
  return __fadd_rn(hi, lo);
}

__device__ __forceinline__ float value(const float* __restrict__ p, int bf16x2) {
  const float v = __ldg(p);
  return bf16x2 ? split_bf16x2(v) : v;
}

__global__ void __launch_bounds__(kThreads)
scatter_unique_sorted_kernel(const int* __restrict__ uids, const float* __restrict__ vals,
                             float* __restrict__ out0, float* __restrict__ out1,
                             long long c, long long vocab, int ew, int e0,
                             int bf16x2, int vec0) {
  __shared__ int slot[kRows];
  __shared__ long long window[2];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = vocab - row0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long at = warp_lower_bound(uids, c, row0 + (warp == 0 ? 0 : rows));
    if ((threadIdx.x & 31) == 0) window[warp] = at;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) slot[r] = -1;
  __syncthreads();
  const long long base = window[0];
  const int count = static_cast<int>(window[1] - base);  // <= rows: ids unique
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    slot[__ldg(uids + base + j) - row0] = j;
  }
  __syncthreads();

  if (vec0) {  // 16-byte stores: e0 % 4 == 0 and out0 aligned
    const int g = e0 >> 2;
    float4* o = reinterpret_cast<float4*>(out0 + row0 * e0);
    for (int i = threadIdx.x; i < rows * g; i += blockDim.x) {
      const int r = i / g;
      const int s = slot[r];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s >= 0) {
        const float* src = vals + (base + s) * ew + 4 * (i - r * g);
        v = make_float4(value(src, bf16x2), value(src + 1, bf16x2),
                        value(src + 2, bf16x2), value(src + 3, bf16x2));
      }
      o[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * e0; i += blockDim.x) {
      const int r = i / e0;
      const int s = slot[r];
      out0[row0 * e0 + i] = s >= 0 ? value(vals + (base + s) * ew + (i - r * e0), bf16x2)
                                   : 0.f;
    }
  }
  const int e1 = ew - e0;
  for (int i = threadIdx.x; i < rows * e1; i += blockDim.x) {
    const int r = i / e1;
    const int s = slot[r];
    out1[row0 * e1 + i] = s >= 0 ? value(vals + (base + s) * ew + e0 + (i - r * e1), bf16x2)
                                 : 0.f;
  }
}

}  // namespace

// uids (c,) int32, vals (c, ew) f32, out0 (vocab, e0) f32, out1 (vocab,
// ew - e0) f32 or null when e0 == ew; all contiguous. Every element of out0
// and out1 is written.
extern "C" int map_tpu_scatter_unique_sorted(const void* uids, const void* vals,
                                             void* out0, void* out1, long long c,
                                             long long vocab, int ew, int e0,
                                             int bf16x2, void* stream) {
  if (vocab <= 0 || ew <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec0 = e0 % 4 == 0 && reinterpret_cast<uintptr_t>(out0) % 16 == 0;
  const long long blocks = (vocab + kRows - 1) / kRows;
  scatter_unique_sorted_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(uids), static_cast<const float*>(vals),
      static_cast<float*>(out0), static_cast<float*>(out1), c, vocab, ew, e0,
      bf16x2, static_cast<int>(vec0));
  return static_cast<int>(cudaGetLastError());
}
