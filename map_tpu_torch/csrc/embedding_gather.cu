// K4: embedding row gather, out[n, :] = table[ids[n], :], optionally cast to
// bf16 on the way out.
//
// Replaces map_tpu/ops/pallas_embedding.py:_gather, which walks a tile of ids
// and keeps a ring of per-row DMAs (HBM -> VMEM) in flight behind DMA
// semaphores. Hopper needs no ring: a warp's loads are already many
// independent 16-byte requests in flight, and the SM hides their latency by
// running other warps.
//
// Bound: device-memory bytes. Per row it reads the 4-byte id and one E-float
// row, and writes one row (E*4 bytes in f32, E*2 in bf16); there is no
// arithmetic. Design: E/4 threads per row, each moving one float4 (16 B), so
// a warp covers 8 rows of the canonical E = 16 in two 128-byte lines each;
// a grid-stride loop over rows * (E/4). The optional f32 -> bf16 cast is fused
// into the store, which halves the write bytes of the serving path. Widths
// that are not a multiple of 4 take a scalar path (one element per thread),
// because their rows are not 16-byte aligned.
//
// ids must lie in [0, V): the kernel does not check them (the caller does,
// map_tpu_torch/serve.py checks every chunk on the host).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
gather_rows_vec4(const float* __restrict__ table, const int* __restrict__ ids,
                 void* __restrict__ out, long long n, int e) {
  const int tpr = e >> 2;  // threads per row
  const long long items = n * tpr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const long long row = i / tpr;
    const int j = static_cast<int>(i - row * tpr);
    const long long src = static_cast<long long>(__ldg(ids + row)) * e + 4 * j;
    const float4 v = __ldg(reinterpret_cast<const float4*>(table + src));
    const long long dst = row * e + 4 * j;
    if (kBf16Out) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + dst) = packed;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + dst) = v;
    }
  }
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
gather_rows_scalar(const float* __restrict__ table, const int* __restrict__ ids,
                   void* __restrict__ out, long long n, int e) {
  const long long items = n * e;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const long long row = i / e;
    const int c = static_cast<int>(i - row * e);
    const float v = __ldg(table + static_cast<long long>(__ldg(ids + row)) * e + c);
    if (kBf16Out) {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(out)[i] = v;
    }
  }
}

}  // namespace

// table (V, e) f32, ids (n,) int32, out (n, e) f32 or bf16; all contiguous.
extern "C" int map_tpu_embedding_gather(const void* table, const void* ids,
                                        void* out, long long n, int e,
                                        int out_bf16, void* stream) {
  if (n <= 0 || e <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = (e % 4) == 0;
  const long long items = vec ? n * (e / 4) : n * e;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* id = static_cast<const int*>(ids);
  const unsigned g = static_cast<unsigned>(blocks);
  if (vec && out_bf16) {
    gather_rows_vec4<true><<<g, kThreads, 0, s>>>(t, id, out, n, e);
  } else if (vec) {
    gather_rows_vec4<false><<<g, kThreads, 0, s>>>(t, id, out, n, e);
  } else if (out_bf16) {
    gather_rows_scalar<true><<<g, kThreads, 0, s>>>(t, id, out, n, e);
  } else {
    gather_rows_scalar<false><<<g, kThreads, 0, s>>>(t, id, out, n, e);
  }
  return static_cast<int>(cudaGetLastError());
}
