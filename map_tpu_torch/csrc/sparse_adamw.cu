// K7: AdamW on the MFP decoder table, its gradient assembled from two sorted
// streams inside the pass. For every row r of p, mu, nu (V, e) f32, in place:
//   g[r] = 0 + (target value of r, if the target stream names r)
//            + (noise value of r, if the noise stream names r)
// in that order, each addition rounded on its own, then K1's AdamW arithmetic
// (adamw_math.cuh) with the decoupled weight decay, lr, b1, b2, eps, bc1
// and bc2 read on the card from the step's row of the optimizer's scalar
// buffer (step_scalars.cuh), so that a captured CUDA graph reads each
// replay's. The decay touches every row, so the pass is dense; a row no
// stream names updates with g = 0.
// Each stream is uids (n,) int32, ascending and distinct below V, followed by
// a sentinel tail (entries >= V), with vals (n, e) f32: the layout of the
// decoder backward's folded stream (map_tpu_torch/ops/dedup_scatter.py
// sort_and_fold), as K5 takes it.
//
// Replaces map_tpu/ops/sparse_adamw.py:sparse_fused_adamw. The TPU kernel
// reads its streams out of an encoded dense cotangent and places each entry
// with one-hot (wblk x 128) MXU matmuls over an exact 3-way bf16 split,
// because the MXU is the TPU's only fast way to place rows. None of that
// carries over. Here each block owns a tile of kRows table rows: four of its
// warps find the tile's window in the target and in the noise stream with a
// warp-wide search (sorted_stream.cuh, as K5), the window entries (at most
// kRows per stream, the ids being distinct) fill two row -> slot maps in
// shared memory, and the block then updates every row of its tile once:
// p, mu, nu and the stream values read with 16-byte loads, p, mu, nu written
// once. No atomics; the result does not depend on scheduling, and the plain
// version (zeros, index_add_ of the target stream, index_add_ of the noise
// stream, K1's plain update) gives the same bits.
//
// Bound: device-memory bytes. p, mu, nu read and written, 24 bytes per
// element (778.4 MB for the decoder's 1,013,519 x 32), plus each stream's
// valid entries (id and e values) read once; about 0.234 ms at 3.35 TB/s.
// The dense route it replaces writes two (V, e + 1) gradients with K5, adds
// them, and reads the sum again in K1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_stream.cuh"
#include "step_scalars.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // table rows per block

__device__ __forceinline__ void add4(float4& g, const float4 v) {
  g.x = __fadd_rn(g.x, v.x);
  g.y = __fadd_rn(g.y, v.y);
  g.z = __fadd_rn(g.z, v.z);
  g.w = __fadd_rn(g.w, v.w);
}

__global__ void __launch_bounds__(kThreads)
sparse_adamw_kernel(float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
                    const int* __restrict__ t_uids, const float* __restrict__ t_vals,
                    long long nt, const int* __restrict__ n_uids,
                    const float* __restrict__ n_vals, long long nn, long long vocab,
                    int e, int vec, const float* __restrict__ scal, float wd) {
  const Scalars s = load_scalars(scal, wd);
  __shared__ int slot_t[kRows];
  __shared__ int slot_n[kRows];
  __shared__ long long window[4];  // target start, end; noise start, end
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = vocab - row0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const int warp = threadIdx.x >> 5;
  if (warp < 4) {
    const bool target = warp < 2;
    const long long at = warp_lower_bound(target ? t_uids : n_uids, target ? nt : nn,
                                          row0 + ((warp & 1) ? rows : 0));
    if ((threadIdx.x & 31) == 0) window[warp] = at;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    slot_t[r] = -1;
    slot_n[r] = -1;
  }
  __syncthreads();
  const long long t_base = window[0], n_base = window[2];
  const int t_count = static_cast<int>(window[1] - t_base);  // <= rows: ids distinct
  const int n_count = static_cast<int>(window[3] - n_base);
  for (int j = threadIdx.x; j < t_count; j += blockDim.x) {
    slot_t[__ldg(t_uids + t_base + j) - row0] = j;
  }
  for (int j = threadIdx.x; j < n_count; j += blockDim.x) {
    slot_n[__ldg(n_uids + n_base + j) - row0] = j;
  }
  __syncthreads();

  if (vec) {  // e % 4 == 0 and every pointer 16-byte aligned
    const int q = e >> 2;
    float4* p4 = reinterpret_cast<float4*>(p + row0 * e);
    float4* m4 = reinterpret_cast<float4*>(mu + row0 * e);
    float4* v4 = reinterpret_cast<float4*>(nu + row0 * e);
    const float4* tv4 = reinterpret_cast<const float4*>(t_vals + t_base * e);
    const float4* nv4 = reinterpret_cast<const float4*>(n_vals + n_base * e);
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q;
      const int c = i - r * q;
      float4 pv = p4[i], mv = m4[i], vv = v4[i];
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      const int st = slot_t[r];
      if (st >= 0) add4(g, __ldg(tv4 + st * q + c));
      const int sn = slot_n[r];
      if (sn >= 0) add4(g, __ldg(nv4 + sn * q + c));
      adamw_elem(pv.x, mv.x, vv.x, g.x, s);
      adamw_elem(pv.y, mv.y, vv.y, g.y, s);
      adamw_elem(pv.z, mv.z, vv.z, g.z, s);
      adamw_elem(pv.w, mv.w, vv.w, g.w, s);
      p4[i] = pv;
      m4[i] = mv;
      v4[i] = vv;
    }
  } else {
    float* pr = p + row0 * e;
    float* mr = mu + row0 * e;
    float* vr = nu + row0 * e;
    for (int i = threadIdx.x; i < rows * e; i += blockDim.x) {
      const int r = i / e;
      const int c = i - r * e;
      float g = 0.f;
      const int st = slot_t[r];
      if (st >= 0) g = __fadd_rn(g, __ldg(t_vals + (t_base + st) * e + c));
      const int sn = slot_n[r];
      if (sn >= 0) g = __fadd_rn(g, __ldg(n_vals + (n_base + sn) * e + c));
      float pv = pr[i], mv = mr[i], vv = vr[i];
      adamw_elem(pv, mv, vv, g, s);
      pr[i] = pv;
      mr[i] = mv;
      vr[i] = vv;
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// p, mu, nu (vocab, e) f32 updated in place; t_uids (nt,) / n_uids (nn,)
// int32 ascending and distinct below vocab, then sentinels >= vocab;
// t_vals (nt, e) / n_vals (nn, e) f32; all contiguous. lr, b1, b2, eps,
// bc1 and bc2 from row `slot` of the optimizer's (slots, 8) float32 scalar
// buffer `scal` on the card (step_scalars.cuh), wd by value.
extern "C" int map_tpu_sparse_adamw(void* p, void* mu, void* nu, const void* t_uids,
                                    const void* t_vals, long long nt,
                                    const void* n_uids, const void* n_vals,
                                    long long nn, long long vocab, int e, float wd,
                                    const void* scal, int slot, void* stream) {
  if (scal == nullptr || slot < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vocab <= 0 || e <= 0) return static_cast<int>(cudaGetLastError());
  const float* row = static_cast<const float*>(scal) + static_cast<long long>(slot) * kScalarWidth;
  const int vec = e % 4 == 0 && aligned16(p) && aligned16(mu) && aligned16(nu) &&
                  aligned16(t_vals) && aligned16(n_vals);
  const long long blocks = (vocab + kRows - 1) / kRows;
  sparse_adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<const int*>(t_uids), static_cast<const float*>(t_vals), nt,
      static_cast<const int*>(n_uids), static_cast<const float*>(n_vals), nn, vocab,
      e, vec, row, wd);
  return static_cast<int>(cudaGetLastError());
}
