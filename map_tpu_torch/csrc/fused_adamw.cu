// K1: one-pass AdamW with decoupled weight decay, p / mu / nu updated in place:
//   mu  = b1 * mu + (1 - b1) * g
//   nu  = b2 * nu + (1 - b2) * g * g
//   upd = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
//   p   = p - lr * upd
// with bc = 1 - b^t computed on the host in float32 (optax.adamw's algebra,
// eps_root = 0).
//
// Replaces map_tpu/ops/fused_adamw.py:fused_adamw_dense, which streams
// (512, W) tiles of p, mu, nu and g through VMEM once and writes p, mu, nu
// back aliased in place. Hopper needs no tiles: the pass is elementwise, so
// a grid-stride loop with one 16-byte vector of each array per thread reads
// every input once and writes every output once.
//
// Bound: device-memory bytes. 4 arrays read and 3 written, 28 bytes per
// element against about 14 operations, far below the card's 295 operations
// per byte. At the canonical table (1,013,519 x 16 f32) that is 454 MB, or
// 0.1355 ms at 3.35 TB/s.
//
// Rounding: the arithmetic is adamw_math.cuh's, shared with K7: every
// operation rounds on its own, in the order above, as the plain PyTorch
// version (map_tpu_torch/ops/fused_adamw.py fused_adamw_plain) and XLA's
// elementwise ops do; kernel and plain version are expected to agree bit for
// bit, and chip_smoke.py holds them to |d| <= 1e-9 + 1e-6 |ref|.
//
// The vector path needs all four pointers 16-byte aligned; the tail of an
// element count that is not a multiple of 4, and any unaligned tensor, go
// element by element in the same launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adamw_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
             const float* __restrict__ g, long long n, int vec, Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(mu);
    float4* v4 = reinterpret_cast<float4*>(nu);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i = tid; i < n4; i += stride) {
      float4 pv = p4[i], mv = m4[i], vv = v4[i];
      const float4 gv = __ldg(g4 + i);
      adamw_elem(pv.x, mv.x, vv.x, gv.x, s);
      adamw_elem(pv.y, mv.y, vv.y, gv.y, s);
      adamw_elem(pv.z, mv.z, vv.z, gv.z, s);
      adamw_elem(pv.w, mv.w, vv.w, gv.w, s);
      p4[i] = pv;
      m4[i] = mv;
      v4[i] = vv;
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float pv = p[i], mv = mu[i], vv = nu[i];
    adamw_elem(pv, mv, vv, __ldg(g + i), s);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// p, mu, nu (n,) f32 updated in place; g (n,) f32; all contiguous.
extern "C" int map_tpu_fused_adamw(void* p, void* mu, void* nu, const void* g,
                                   long long n, float lr, float wd, float b1,
                                   float b2, float eps, float bc1, float bc2,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Scalars s = make_scalars(lr, wd, b1, b2, eps, bc1, bc2);
  const int vec = aligned16(p) && aligned16(mu) && aligned16(nu) && aligned16(g);
  const long long items = vec ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<const float*>(g), n, vec, s);
  return static_cast<int>(cudaGetLastError());
}
