// K2: the DCNv2 cross network, all L layers in one kernel:
//   U_l = round_T(X_l W_l^T + b_l)   (f32 accumulate, then one rounding)
//   X_{l+1} = X_l + X_0 * U_l        (torch's roundings: the product, then the sum)
// W is (L, D, D) in nn.Linear layout (out, in), b is (L, D); x0, w, b, y and
// the residuals share one dtype T, f32 or bf16. With residual outputs it also
// writes X_l and U_l as (L, B, D) for the backward of the training path.
//
// Replaces map_tpu/ops/pallas_cross.py:_cross_forward, which keeps a batch
// tile of X_0 and X_l resident in VMEM across the L layers so that only the
// weights stream from HBM. The same idea holds here: one block owns TB rows,
// keeps X_0, X_l and X_{l+1} of those rows in shared memory for all L layers,
// and streams W through shared memory in chunks of 128 output rows from L2
// (W is 1.7 MB in f32 at D = 384, so every block finds it in L2). Device
// memory sees X_0 read once and Y written once (plus the residuals).
//
// Bound at the serving shape (B = 10000, D = 384, L = 3): 2*L*B*D^2 = 8.8
// GFLOP against 15 MB of bf16 traffic, so operations bound it (about 295
// operations per byte are needed before bytes would). bf16 tiles therefore run
// on the tensor cores (WMMA 16x16x16, f32 accumulate); f32 tiles run as FMA
// loops on the CUDA cores, in full f32 as the plain version does.
//
// With one or two blocks on an SM, the latency of the W reads from L2 is what
// a block waits on, not the products. So each thread reads its part of the
// next W chunk into registers (16-byte loads) while the block multiplies the
// current one, and stores it to shared memory after: one chunk in flight
// behind every chunk in use, across passes and layers.
//
// Any D: the tile is padded in shared memory to a multiple of 128 columns with
// zeros, and every global read and write is masked to D. (The TPU kernel needs
// D % 128 == 0, pallas_cross.py:51; that limit does not carry over.) W is read
// 16 bytes at a time where D is a multiple of 16 bytes' worth of elements and
// W is 16-byte aligned, else one element at a time. The host picks the largest
// tile of 64, 32 or 16 rows whose shared memory fits the card, so D = 624
// (Criteo, 39 x 16) takes 32-row bf16 and 16-row f32 tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kNT = 128;       // output columns per pass
constexpr int kKcF32 = 32;     // depth of one W chunk, f32
constexpr int kKcBf16 = 64;    // depth of one W chunk, bf16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The bits of one element, for element-wise reads of W.
template <typename T> struct RawOf { using type = unsigned int; };
template <> struct RawOf<bf16> { using type = unsigned short; };

// One thread's share of a W chunk (rows [n0, n0 + kNT), depth [k0, k0 + KC)
// of one layer), held in registers as 16-byte pieces between the read from
// global memory and the store to shared memory. Piece v of the chunk is row
// v / kPiecesPerRow, depth (v % kPiecesPerRow) * kElems: eight neighbouring
// threads read one row's 128 contiguous bytes.
template <typename T, int KC>
struct WChunk {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPiecesPerRow = KC / kElems;
  static constexpr int kPerThread = kNT * kPiecesPerRow / kThreads;
  static_assert(kNT * kPiecesPerRow % kThreads == 0, "chunk / threads");
  uint4 r[kPerThread];

  __device__ __forceinline__ static int row(int j) {
    return (threadIdx.x + j * kThreads) / kPiecesPerRow;
  }
  __device__ __forceinline__ static int col(int j) {
    return (threadIdx.x + j * kThreads) % kPiecesPerRow * kElems;
  }

  // Zero outside [0, d) x [0, d).
  template <bool kVec>
  __device__ __forceinline__ void fetch(const T* __restrict__ wl, int n0, int k0,
                                        int d) {
    using Raw = typename RawOf<T>::type;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int n = n0 + row(j), k = k0 + col(j);
      const T* src = wl + static_cast<long long>(n) * d + k;
      if (kVec) {  // d % kElems == 0: a piece is wholly inside or outside
        r[j] = (n < d && k < d) ? __ldg(reinterpret_cast<const uint4*>(src))
                                : make_uint4(0u, 0u, 0u, 0u);
      } else {
        Raw e[kElems];
#pragma unroll
        for (int q = 0; q < kElems; ++q)
          e[q] = (n < d && k + q < d) ? __ldg(reinterpret_cast<const Raw*>(src) + q)
                                      : Raw(0);
        memcpy(&r[j], e, sizeof(e));
      }
    }
  }
};

// The layer, pass and chunk that follow (l, p, kc), or l == layers at the end.
__device__ __forceinline__ void next_chunk(int& l, int& p, int& kc, int npass,
                                           int nk) {
  if (++kc < nk) return;
  kc = 0;
  if (++p < npass) return;
  p = 0;
  ++l;
}

// X_0 rows [r0, r0 + rows) into both x0s and xi, zero past the batch and D.
template <typename T>
__device__ void load_tile(const T* __restrict__ x0, T* x0s, T* xi, long long r0,
                          int rows, int batch, int d, int dp, int ld) {
  for (int i = threadIdx.x; i < rows * dp; i += kThreads) {
    const int r = i / dp, c = i - r * dp;
    const long long g = r0 + r;
    const T v = (g < batch && c < d) ? x0[g * d + c] : from_f<T>(0.f);
    x0s[r * ld + c] = v;
    xi[r * ld + c] = v;
  }
}

template <typename T>
__device__ void store_tile(const T* tile, T* __restrict__ out, long long r0,
                           int rows, int batch, int d, int ld) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const long long g = r0 + r;
    if (g < batch) out[g * d + c] = tile[r * ld + c];
  }
}

// X_l + X_0 * U with a rounding to T after the product and after the sum, as
// two torch ops give (no fused multiply-add).
template <typename T>
__device__ __forceinline__ T cross_update(T x0v, T xiv, T u) {
  const float p = to_f(from_f<T>(__fmul_rn(to_f(x0v), to_f(u))));
  return from_f<T>(__fadd_rn(to_f(xiv), p));
}

// ---- f32: FMA loops. TB = 8 * RM rows; warp ty owns rows ty + 8i, lane tx
// owns columns tx + 32j of each 128-column pass (RM x 4 accumulators).
template <int RM, bool kVec>
__global__ void __launch_bounds__(kThreads) cross_net_f32(
    const float* __restrict__ x0, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y,
    float* __restrict__ xs_out, float* __restrict__ us_out, int batch, int d,
    int dp, int layers) {
  constexpr int TB = 8 * RM;
  constexpr int KC = kKcF32;
  constexpr int kWld = kNT + 1;  // wch[kk][nn], padded against bank conflicts
  using Chunk = WChunk<float, KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = dp + 1;
  float* x0s = reinterpret_cast<float*>(smem);
  float* xi = x0s + TB * ld;
  float* xn = xi + TB * ld;
  float* wch = xn + TB * ld;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * TB;
  const long long dd = static_cast<long long>(d) * d;
  const int npass = dp / kNT, nk = dp / KC;

  Chunk wc;
  wc.template fetch<kVec>(w, 0, 0, d);
  load_tile(x0, x0s, xi, r0, TB, batch, d, dp, ld);
  __syncthreads();
  for (int l = 0; l < layers; ++l) {
    const float* bl = bias + static_cast<long long>(l) * d;
    if (xs_out) store_tile(xi, xs_out + static_cast<long long>(l) * batch * d, r0,
                           TB, batch, d, ld);
    for (int p = 0; p < npass; ++p) {
      const int n0 = p * kNT;
      float acc[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int kc = 0; kc < nk; ++kc) {
        __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
        for (int j = 0; j < Chunk::kPerThread; ++j) {
          float* dst = wch + Chunk::col(j) * kWld + Chunk::row(j);
          dst[0] = __uint_as_float(wc.r[j].x);
          dst[kWld] = __uint_as_float(wc.r[j].y);
          dst[2 * kWld] = __uint_as_float(wc.r[j].z);
          dst[3 * kWld] = __uint_as_float(wc.r[j].w);
        }
        __syncthreads();
        int nl = l, np = p, nkc = kc;
        next_chunk(nl, np, nkc, npass, nk);
        if (nl < layers) wc.template fetch<kVec>(w + nl * dd, np * kNT, nkc * KC, d);
        const int k0 = kc * KC;
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
          float a[RM], bv[4];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = xi[(ty + 8 * i) * ld + k0 + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = wch[kk * kWld + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 8 * i;
        const long long g = r0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 32 * j;
          const float u = acc[i][j] + (n < d ? bl[n] : 0.f);
          xn[r * ld + n] = cross_update(x0s[r * ld + n], xi[r * ld + n], u);
          if (us_out && g < batch && n < d)
            us_out[(static_cast<long long>(l) * batch + g) * d + n] = u;
        }
      }
    }
    __syncthreads();  // X_{l+1} complete before it becomes the next input
    float* t = xi;
    xi = xn;
    xn = t;
  }
  store_tile(xi, y, r0, TB, batch, d, ld);
}

// ---- bf16: WMMA 16x16x16 on the tensor cores, f32 accumulate. TB = 16 * FR
// rows; warp w owns output columns [16w, 16w + 16) of each 128-column pass
// across all FR row fragments. A pass's f32 products are staged in shared
// memory for the elementwise epilogue.
template <int FR, bool kVec>
__global__ void __launch_bounds__(kThreads) cross_net_bf16(
    const bf16* __restrict__ x0, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, bf16* __restrict__ y,
    bf16* __restrict__ xs_out, bf16* __restrict__ us_out, int batch, int d,
    int dp, int layers) {
  using namespace nvcuda;
  constexpr int TB = 16 * FR;
  constexpr int KC = kKcBf16;
  constexpr int kWld = KC + 8;  // wch[nn][kk]: W rows are k-contiguous
  constexpr int kAld = kNT + 4;
  using Chunk = WChunk<bf16, KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = dp + 8;
  bf16* x0s = reinterpret_cast<bf16*>(smem);
  bf16* xi = x0s + TB * ld;
  bf16* xn = xi + TB * ld;
  bf16* wch = xn + TB * ld;
  float* accs = reinterpret_cast<float*>(wch + kNT * kWld);
  const int warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * TB;
  const long long dd = static_cast<long long>(d) * d;
  const int npass = dp / kNT, nk = dp / KC;

  Chunk wc;
  wc.template fetch<kVec>(w, 0, 0, d);
  load_tile(x0, x0s, xi, r0, TB, batch, d, dp, ld);
  __syncthreads();
  for (int l = 0; l < layers; ++l) {
    const bf16* bl = bias + static_cast<long long>(l) * d;
    if (xs_out) store_tile(xi, xs_out + static_cast<long long>(l) * batch * d, r0,
                           TB, batch, d, ld);
    for (int p = 0; p < npass; ++p) {
      const int n0 = p * kNT;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR];
#pragma unroll
      for (int f = 0; f < FR; ++f) wmma::fill_fragment(acc[f], 0.f);
      for (int kc = 0; kc < nk; ++kc) {
        __syncthreads();
#pragma unroll
        for (int j = 0; j < Chunk::kPerThread; ++j)  // 16-byte aligned: kWld * 2 = 144
          *reinterpret_cast<uint4*>(wch + Chunk::row(j) * kWld + Chunk::col(j)) =
              wc.r[j];
        __syncthreads();
        int nl = l, np = p, nkc = kc;
        next_chunk(nl, np, nkc, npass, nk);
        if (nl < layers) wc.template fetch<kVec>(w + nl * dd, np * kNT, nkc * KC, d);
        const int k0 = kc * KC;
#pragma unroll
        for (int ks = 0; ks < KC; ks += 16) {
          // B(k, n) = W[n][k]: column-major over the chunk's [nn][kk] rows
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, wch + warp * 16 * kWld + ks, kWld);
#pragma unroll
          for (int f = 0; f < FR; ++f) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
            wmma::load_matrix_sync(af, xi + f * 16 * ld + k0 + ks, ld);
            wmma::mma_sync(acc[f], af, bf, acc[f]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < FR; ++f)
        wmma::store_matrix_sync(accs + f * 16 * kAld + warp * 16, acc[f], kAld,
                                wmma::mem_row_major);
      __syncthreads();
      for (int i = threadIdx.x; i < TB * kNT; i += kThreads) {
        const int r = i / kNT, nn = i - r * kNT;
        const int n = n0 + nn;
        const long long g = r0 + r;
        const bf16 u = from_f<bf16>(accs[r * kAld + nn] +
                                    (n < d ? to_f(bl[n]) : 0.f));
        xn[r * ld + n] = cross_update(x0s[r * ld + n], xi[r * ld + n], u);
        if (us_out && g < batch && n < d)
          us_out[(static_cast<long long>(l) * batch + g) * d + n] = u;
      }
    }
    __syncthreads();
    bf16* t = xi;
    xi = xn;
    xn = t;
  }
  store_tile(xi, y, r0, TB, batch, d, ld);
}

size_t smem_f32(int tb, int dp) {
  return (3 * static_cast<size_t>(tb) * (dp + 1) + kKcF32 * (kNT + 1)) * sizeof(float);
}

size_t smem_bf16(int tb, int dp) {
  return 3 * static_cast<size_t>(tb) * (dp + 8) * sizeof(bf16) +
         static_cast<size_t>(kNT) * (kKcBf16 + 8) * sizeof(bf16) +
         static_cast<size_t>(tb) * (kNT + 4) * sizeof(float);
}

template <typename T>
using CrossKernel = void (*)(const T*, const T*, const T*, T*, T*, T*, int, int,
                             int, int);

// The kernel for a tile of tb rows, W read 16 bytes at a time if vec.
template <bool kVec>
CrossKernel<float> pick_f32(int tb) {
  return tb == 64 ? &cross_net_f32<8, kVec>
       : tb == 32 ? &cross_net_f32<4, kVec> : &cross_net_f32<2, kVec>;
}

template <bool kVec>
CrossKernel<bf16> pick_bf16(int tb) {
  return tb == 64 ? &cross_net_bf16<4, kVec>
       : tb == 32 ? &cross_net_bf16<2, kVec> : &cross_net_bf16<1, kVec>;
}

template <typename T>
cudaError_t launch(CrossKernel<T> kernel, int tb, size_t smem, cudaStream_t s,
                   const void* x0, const void* w, const void* b, void* y,
                   void* xs, void* us, int batch, int d, int dp, int layers) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((batch + tb - 1) / tb);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x0), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), static_cast<T*>(xs), static_cast<T*>(us), batch, d, dp,
      layers);
  return cudaGetLastError();
}

}  // namespace

// x0 (batch, d), w (layers, d, d), b (layers, d), y (batch, d); xs and us are
// (layers, batch, d) or null. All contiguous, one dtype (is_bf16 ? bf16 : f32).
extern "C" int map_tpu_cross_net(const void* x0, const void* w, const void* b,
                                 void* y, void* xs, void* us, int batch, int d,
                                 int layers, int is_bf16, void* stream) {
  if (batch <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const int dp = (d + kNT - 1) / kNT * kNT;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elems16 = is_bf16 ? 8 : 4;  // elements in 16 bytes
  const bool vec = d % elems16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  for (int tb = 64; tb >= 16; tb /= 2) {
    const size_t smem = is_bf16 ? smem_bf16(tb, dp) : smem_f32(tb, dp);
    if (smem > static_cast<size_t>(optin)) continue;
    if (is_bf16)
      return static_cast<int>(launch<bf16>(
          vec ? pick_bf16<true>(tb) : pick_bf16<false>(tb), tb, smem, s, x0, w, b,
          y, xs, us, batch, d, dp, layers));
    return static_cast<int>(launch<float>(
        vec ? pick_f32<true>(tb) : pick_f32<false>(tb), tb, smem, s, x0, w, b, y,
        xs, us, batch, d, dp, layers));
  }
  return static_cast<int>(cudaErrorInvalidValue);  // D too wide for one tile
}
