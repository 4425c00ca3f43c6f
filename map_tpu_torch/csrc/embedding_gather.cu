// K4: embedding row gather, out[n, :] = table[ids[n], :], optionally cast to
// bf16 on the way out.
//
// Replaces map_tpu/ops/pallas_embedding.py:_gather, which walks a tile of ids
// and keeps a ring of NUM_INFLIGHT per-row DMAs (HBM -> VMEM) in flight
// behind DMA semaphores.
//
// Bound: device-memory bytes. Per row it reads the 4-byte id and one E-float
// row, and writes one row (E*4 bytes in f32, E*2 in bf16); there is no
// arithmetic. Two dependent loads stand before each store (the id, then the
// row it names), so what a thread keeps in flight decides how close it
// comes.
//
// Design (the launch plan is map_tpu_torch/ops/embedding.py:plan). The
// output is cut into units of kVec floats: 4 (a 16-byte load and store), or
// 8 in bf16 out with E % 8 == 0 (two 16-byte loads, one 16-byte store of 8
// bf16 values). Block x takes a tile of kThreads * kUnits consecutive units,
// thread t its units t, t + kThreads, ..., so each of its warp's loads and
// stores covers 32 consecutive units. A thread loads all of its units' ids,
// then all of their rows, then stores them: its kUnits row loads (the
// counterpart of the TPU kernel's DMA ring) wait on one id latency, not one
// each, and the lanes of a row read its id in the same load. One wave of
// tiles covers the output; the grid walks on past it only beyond
// kMaxBlocks. Widths that are not a multiple of 4, or a table not 16-byte
// aligned, take a scalar path (one element per thread), because their rows
// are not 16-byte aligned.
//
// ids must lie in [0, V): the kernel does not check them (the caller does,
// map_tpu_torch/serve.py checks every chunk on the host).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

template <int kVec>
struct Unit {
  float4 v[kVec / 4];
};

template <int kVec, bool kBf16Out>
__device__ __forceinline__ void store_unit(void* out, long long at, const Unit<kVec>& x) {
  if constexpr (!kBf16Out) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = x.v[0];
  } else {
    uint32_t w[kVec / 2];
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(x.v[i].x, x.v[i].y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(x.v[i].z, x.v[i].w);
      w[2 * i] = *reinterpret_cast<uint32_t*>(&lo);
      w[2 * i + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
    }
  }
}

// kUnits units of kVec floats a thread; table and out 16-byte aligned,
// e % kVec == 0
template <int kUnits, int kVec, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
gather_rows_batched(const float* __restrict__ table, const int* __restrict__ ids,
                    void* __restrict__ out, long long n, int e) {
  const int per_row = e / kVec;  // units a row
  const long long units = n * per_row;
  constexpr long long kTile = static_cast<long long>(kThreads) * kUnits;
  for (long long t0 = blockIdx.x * kTile + threadIdx.x; t0 < units;
       t0 += static_cast<long long>(gridDim.x) * kTile) {
    long long row[kUnits];
    int piece[kUnits], id[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const long long i = t0 + k * kThreads;
      row[k] = i / per_row;
      piece[k] = static_cast<int>(i - row[k] * per_row);
      id[k] = i < units ? __ldg(ids + row[k]) : 0;
    }
    Unit<kVec> x[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (t0 + k * kThreads < units) {
        const float4* src = reinterpret_cast<const float4*>(
            table + static_cast<long long>(id[k]) * e + piece[k] * kVec);
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) x[k].v[j] = __ldg(src + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const long long i = t0 + k * kThreads;
      if (i < units) store_unit<kVec, kBf16Out>(out, i * kVec, x[k]);
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

template <int kVec, bool kBf16Out>
void launch_batched(int units_a_thread, unsigned blocks, const float* t, const int* id,
                    void* out, long long n, int e, cudaStream_t s) {
  if (units_a_thread == 1) {
    gather_rows_batched<1, kVec, kBf16Out><<<blocks, kThreads, 0, s>>>(t, id, out, n, e);
  } else if (units_a_thread == 2) {
    gather_rows_batched<2, kVec, kBf16Out><<<blocks, kThreads, 0, s>>>(t, id, out, n, e);
  } else {
    gather_rows_batched<4, kVec, kBf16Out><<<blocks, kThreads, 0, s>>>(t, id, out, n, e);
  }
}

}  // namespace

// table (V, e) f32, ids (n,) int32, out (n, e) f32 or bf16; all contiguous.
// The plan (ops/embedding.py:plan), on `blocks` blocks (at most 65535):
// vec = 0 takes the scalar path; vec = 4 or 8 the batched one, with
// units_a_thread 1, 2 or 4 units of vec floats a thread, e % vec == 0, table
// and out 16-byte aligned, vec = 8 with bf16 out only. A plan that does not
// fit is refused with cudaErrorInvalidValue.
extern "C" int map_tpu_embedding_gather(const void* table, const void* ids, void* out,
                                        long long n, int e, int out_bf16, int vec,
                                        int units_a_thread, int blocks, void* stream) {
  if (n <= 0 || e <= 0) return static_cast<int>(cudaGetLastError());
  if (blocks < 1 || blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* id = static_cast<const int*>(ids);
  const unsigned g = static_cast<unsigned>(blocks);
  if (vec == 0) {
    if (out_bf16) {
      gather_rows_scalar<true><<<g, kThreads, 0, s>>>(t, id, out, n, e);
    } else {
      gather_rows_scalar<false><<<g, kThreads, 0, s>>>(t, id, out, n, e);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if ((vec != 4 && vec != 8) || (vec == 8 && !out_bf16) || e % vec != 0 || !aligned ||
      (units_a_thread != 1 && units_a_thread != 2 && units_a_thread != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 8) {
    launch_batched<8, true>(units_a_thread, g, t, id, out, n, e, s);
  } else if (out_bf16) {
    launch_batched<4, true>(units_a_thread, g, t, id, out, n, e, s);
  } else {
    launch_batched<4, false>(units_a_thread, g, t, id, out, n, e, s);
  }
  return static_cast<int>(cudaGetLastError());
}
