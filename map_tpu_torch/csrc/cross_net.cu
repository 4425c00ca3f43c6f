// K2: the DCNv2 cross network, all L layers in one kernel:
//   U_l = round_T(X_l W_l^T + b_l)   (f32 accumulate, then one rounding)
//   X_{l+1} = X_l + X_0 * U_l        (torch's roundings: the product, then the sum)
// W is (L, D, D) in nn.Linear layout (out, in), b is (L, D); x0, w, b, y and
// the residuals share one dtype T, f32 or bf16. With residual outputs it also
// writes X_l and U_l as (L, B, D) for the backward of the training path.
//
// Replaces map_tpu/ops/pallas_cross.py:_cross_forward, which keeps a batch
// tile of X_0 and X_l resident in VMEM across the L layers so that only the
// weights stream from HBM. Cut for 132 SMs:
//
// - A cluster of C = dp / 128 blocks owns a tile of rows (dp: D rounded up to
//   128; C <= 8). Block c of the cluster computes output columns
//   [128c, 128c + 128) of every layer from the whole X_l tile (all dp
//   columns, the depth of its product) and streams only its 128 rows of each
//   W_l: at (10000, 384), 157 tiles x 3 blocks, each block reading 3 x 128 x
//   384 W elements from L2 (295 KB in bf16, 590 KB in f32), 139 MB and 278 MB
//   in all. The blocks of a cluster meet once or twice a layer; a row tile
//   is spread over C SMs, so 64-row tiles give the training batch (4096) 192
//   blocks.
// - bf16: one warpgroup runs wgmma m64n128k16 (f32 accumulate) with X_l as
//   the A operand and W's rows (k-contiguous) as the B operand, both in
//   shared memory in the 128-byte-swizzled layout. A producer warp brings the
//   X_0 tile and then W in (128 x 64) chunks by TMA (cp.async.bulk.tensor)
//   into a ring of 2-4 stages guarded by mbarriers, across layers. The
//   epilogue runs in registers from the accumulator layout: bias, then the
//   three roundings; it writes U_l to global memory and the block's columns
//   of X_{l+1} into its own next X tile, and one thread pushes them (two
//   whole 8 KB chunks of the swizzled tile) into every other block's tile by
//   bulk copies between shared memories (cp.async.bulk.shared::cluster),
//   each completing on the receiver's mbarrier. With one X tile (two blocks
//   an SM at D = 384; D > 640) a second barrier says every block is done
//   with its product before a push overwrites X_l.
// - f32: register-tiled FMA in full f32 (no TF32), 8 x 8 outputs a thread;
//   X_l and W stream from L2 by cp.async through a 3-stage ring, and the
//   blocks pass X_{l+1} through global memory with a cluster barrier between
//   layers (see the f32 section).
//
// Bound at the serving shape (B = 10000, D = 384, L = 3): 2*L*B*D^2 = 8.8
// GFLOP against 15 MB of bf16 traffic, so operations bound it; the training
// call (4096 rows with the residuals) is bound by its 26 MB of bytes in bf16.
//
// Any D <= 1024: columns past D are zero in every tile (W's rows and depth
// past D read as zero) and every global read and write is masked to D and
// the batch. Where D * sizeof(T) is not a multiple of 16 bytes or W or x0
// is not 16-byte aligned, TMA and 16-byte copies cannot be used: the bf16
// producer warp then writes W chunks element by element into the layout TMA
// would have written and the consumers load X_0 the same way; f32 copies W
// by 4-byte cp.async and reads X element by element. The launch plan (tile
// rows, cluster, grid, shared memory, stages, X tiles, load path) comes from
// map_tpu_torch/ops/cross.py:plan; this entry checks it against the shapes
// and returns cudaErrorInvalidValue for one that does not fit.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCols = 128;     // output columns a block
constexpr int kMaxCluster = 8;
// f32
constexpr int kF32Stages = 3;         // X and W chunks in the ring
// bf16
constexpr int kBfThreads = 160;       // warps 0-3 (one warpgroup) + a producer warp
constexpr int kBfRows = 64;           // one wgmma tile
constexpr int kBfKc = 64;             // depth of a W chunk: one 128-byte row
constexpr int kChunkBytes = kBfRows * 128;        // an X chunk: 64 rows x 128 B
constexpr int kWChunkBytes = kCols * 128;         // a W chunk: 128 rows x 128 B

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async ----------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
// Arrive on the barrier at the same offset in block `rank` of the cluster,
// releasing this thread's earlier writes to the cluster.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)), "r"(rank) : "memory");
}
// A wait that never ends is a fault of the kernel: it traps (the launch
// fails with an error) after about 2^26 polls, seconds, not hangs.
constexpr unsigned kMaxPolls = 1u << 26;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}
// The same, acquiring what other blocks of the cluster released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// ---- wgmma -------------------------------------------------------------------
// A shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the layout TMA's SWIZZLE_128B writes for 128-byte rows).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Byte offset of element (r, k) in a swizzled X tile: 64-column chunks of
// 64 rows x 128 bytes, the 16-byte unit of a row XORed with r % 8.
__device__ __forceinline__ int x_offset(int r, int k) {
  const int kb = (k & 63) * 2;
  return (k >> 6) * kChunkBytes + r * 128 + ((((kb >> 4) ^ (r & 7))) << 4) + (kb & 15);
}

// Per-block timestamps (globaltimer, ns) and SM, for a traced build only
// (-DMAP_TPU_CROSS_TRACE, map_tpu_torch/kernels/cross_trace.py): slot 0
// start, 1 set-up done (bf16: X_0 in), 2 + 2l end of layer l's product,
// 3 + 2l end of its epilogue and exchange, 14 end, 15 the SM.
#ifdef MAP_TPU_CROSS_TRACE
__device__ unsigned long long g_cross_trace[8192 * 16];
__device__ __forceinline__ void trace(int slot) {
  if (threadIdx.x != 0 || blockIdx.x >= 8192) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_cross_trace[blockIdx.x * 16 + slot] = t;
  if (slot == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_cross_trace[blockIdx.x * 16 + 15] = sm;
  }
}
#else
__device__ __forceinline__ void trace(int) {}
#endif

// ---- cluster barrier (f32's exchange) -------------------------------------------
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}


// ---- f32: register-tiled FMA -------------------------------------------------
// A block of 64 rows x 128 columns runs 128 threads, each owning 8 x 8
// outputs: lane (ly, lx) of 4 x 8, warp (wy, wx) of 2 x 2; rows wy * 32 + ly
// + 4i, columns wx * 64 + lx + 8j (i, j < 8). A depth step of 4 reads 8 + 8
// float4 from shared memory for 256 FMAs. An SM moves 128 bytes a cycle from
// shared memory into registers, so 8 x 8 outputs a thread just balance the
// 128 FMAs a cycle (8 x 4 would leave the FMA pipes a third idle; 8 x 16,
// with 128-row tiles or with four 64-row blocks an SM, measured slower on
// the H100). X_l is not held on chip: like W it streams from L2 in (64, 32)
// chunks by cp.async (.cg: L2 only, so a tile written in this launch by
// another SM is never read stale from L1), through a 3-stage ring beside W's
// (128, 32). So a block holds 3 x (64 + 128) x 36 floats whatever D is, and
// two fit an SM. Between layers the cluster's blocks write their columns of
// X_{l+1} to global memory (the X_l residual, or a two-layer scratch, or Y
// at the last layer) and meet at a cluster barrier. The epilogue reads the
// block's columns of X_0 and X_l from the ring's space, staged there by
// cp.async in one round trip to L2.
constexpr int kF32Rows = 64;
constexpr int kF32Threads = 2 * kF32Rows;
constexpr int kF32Kc = 32;
constexpr int kEld = kCols + 8;  // staged tile rows 8 banks apart: lanes read distinct banks

__device__ __forceinline__ const float* x_layer(const float* x0, const float* xs_out,
                                                const float* scratch, long long slab,
                                                int l) {
  if (l == 0) return x0;
  return xs_out ? xs_out + l * slab : scratch + (l & 1) * slab;
}

// Chunk kc of layer l: X_l rows [r0, r0 + kF32Rows) and W_l rows [n0, n0 + 128), depth
// [kc * 32, kc * 32 + 32), into ring slot `slot`; zero past the batch and D.
template <bool kVec>
__device__ __forceinline__ void load_chunk_f32(const float* __restrict__ xl,
                                               const float* __restrict__ w, float* xr,
                                               float* wr, int l, int kc, int slot,
                                               long long r0, int n0, int batch, int d) {
  constexpr int kLd = kF32Kc + 4;
  const int k0 = kc * kF32Kc;
  const float* wl = w + static_cast<long long>(l) * d * d;
  float* xdst = xr + slot * kF32Rows * kLd;
  float* wdst = wr + slot * kCols * kLd;
  if (kVec) {  // d % 4 == 0: a 16-byte piece is wholly inside or outside
#pragma unroll
    for (int j = 0; j < kF32Rows * kF32Kc / 4 / kF32Threads; ++j) {
      const int p = threadIdx.x + j * kF32Threads, row = p >> 3, q = (p & 7) * 4;
      const long long g = r0 + row;
      const bool in = g < batch && k0 + q < d;
      cp_async16(xdst + row * kLd + q, in ? xl + g * d + k0 + q : w, in ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kCols * kF32Kc / 4 / kF32Threads; ++j) {
      const int p = threadIdx.x + j * kF32Threads, row = p >> 3, q = (p & 7) * 4;
      const int n = n0 + row;
      const bool in = n < d && k0 + q < d;
      cp_async16(wdst + row * kLd + q,
                 in ? wl + static_cast<long long>(n) * d + k0 + q : w, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kF32Rows * kF32Kc; e += kF32Threads) {
      const int row = e >> 5, q = e & 31;
      const long long g = r0 + row;
      xdst[row * kLd + q] = (g < batch && k0 + q < d) ? __ldcg(xl + g * d + k0 + q) : 0.f;
    }
    for (int e = threadIdx.x; e < kCols * kF32Kc; e += kF32Threads) {
      const int row = e >> 5, q = e & 31, n = n0 + row;
      const bool in = n < d && k0 + q < d;
      cp_async4(wdst + row * kLd + q, in ? wl + static_cast<long long>(n) * d + k0 + q : w,
                in ? 4 : 0);
    }
  }
}

// Our columns [n0, n0 + 128) of rows [r0, r0 + kF32Rows) of x (batch, d) into a
// (kF32Rows, kEld) tile, zero past the batch and D (cp.async, not waited for).
template <bool kVec>
__device__ __forceinline__ void stage_columns_f32(const float* x, float* tile, long long r0,
                                                  int n0, int batch, int d) {
  if (kVec) {
    for (int p = threadIdx.x; p < kF32Rows * kCols / 4; p += kF32Threads) {
      const int r = p >> 5, q = (p & 31) * 4;
      const long long g = r0 + r;
      const bool in = g < batch && n0 + q < d;
      cp_async16(tile + r * kEld + q, in ? x + g * d + n0 + q : x, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kF32Rows * kCols; e += kF32Threads) {
      const int r = e >> 7, q = e & (kCols - 1);
      const long long g = r0 + r;
      tile[r * kEld + q] = (g < batch && n0 + q < d) ? __ldcg(x + g * d + n0 + q) : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kF32Threads, 2) cross_net_f32(
    const float* __restrict__ x0, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, float* __restrict__ xs_out,
    float* __restrict__ us_out, float* __restrict__ scratch, int batch, int d, int dp,
    int layers) {
  constexpr int kLd = kF32Kc + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xr = reinterpret_cast<float*>(smem);  // [3][kF32Rows][kLd]
  float* wr = xr + 3 * kF32Rows * kLd;               // [3][kCols][kLd]
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int n0 = static_cast<int>(cluster.block_rank()) * kCols;
  const long long r0 = static_cast<long long>(blockIdx.x / csize) * kF32Rows;
  const long long slab = static_cast<long long>(batch) * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rbase = (warp >> 1) * 32 + (lane >> 3);
  const int cbase = (warp & 1) * 64 + (lane & 7);
  const int nk = dp / kF32Kc;
  trace(0);
  if (xs_out) {  // X_0 is the first residual: our columns of it
    for (int e = threadIdx.x; e < kF32Rows * kCols; e += kF32Threads) {
      const int r = e >> 7, n = n0 + (e & (kCols - 1));
      const long long g = r0 + r;
      if (g < batch && n < d) xs_out[g * d + n] = x0[g * d + n];
    }
  }
  trace(1);
  for (int l = 0; l < layers; ++l) {
    const float* xl = x_layer(x0, xs_out, scratch, slab, l);
#pragma unroll
    for (int s = 0; s < kF32Stages - 1; ++s) {
      if (s < nk)
        load_chunk_f32<kVec>(xl, w, xr, wr, l, s, s, r0, n0, batch, d);
      cp_async_commit();
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<kF32Stages - 2>();
      __syncthreads();  // chunk kc landed; every thread is done with chunk kc - 1
      if (kc + kF32Stages - 1 < nk)
        load_chunk_f32<kVec>(xl, w, xr, wr, l, kc + kF32Stages - 1,
                                           (kc + kF32Stages - 1) % kF32Stages, r0, n0,
                                           batch, d);
      cp_async_commit();
      const int slot = kc % kF32Stages;
      const float* xa = xr + (slot * kF32Rows + rbase) * kLd;
      const float* wb = wr + (slot * kCols + cbase) * kLd;
      // (not unrolled across depth steps: 64 accumulators and one step's 16
      // float4 fit the registers without spilling, 145 of them; unrolled by
      // 2, 4 or 8 the compiler spills or nears 255, and the time on the
      // H100 did not improve; the SM's other warps cover the loads' latency)
#pragma unroll 1
      for (int kq = 0; kq < kF32Kc; kq += 4) {
        float4 a[8], bq[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(xa + 4 * i * kLd + kq);
#pragma unroll
        for (int j = 0; j < 8; ++j) bq[j] = *reinterpret_cast<const float4*>(wb + 8 * j * kLd + kq);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i].x, bq[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, bq[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, bq[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, bq[j].w, acc[i][j]);
          }
      }
    }
    trace(2 + 2 * l);
    // epilogue: our columns of X_0 and X_l staged in the ring's space, then
    // U_l = acc + b and X_{l+1} = X_l + X_0 * U_l
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
    float* x0t = xr;                              // [kF32Rows][kEld]
    float* xlt = l == 0 ? x0t : x0t + kF32Rows * kEld;  // [kF32Rows][kEld]
    stage_columns_f32<kVec>(x0, x0t, r0, n0, batch, d);
    if (l > 0) stage_columns_f32<kVec>(xl, xlt, r0, n0, batch, d);
    cp_async_commit();
    const float* bl = bias + static_cast<long long>(l) * d;
    float* xn = l + 1 == layers ? y : xs_out ? xs_out + (l + 1) * slab
                                             : scratch + ((l + 1) & 1) * slab;
    float bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cbase + 8 * j;
      bv[j] = n < d ? bl[n] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rbase + 4 * i;
      const long long g = r0 + r;
      if (g >= batch) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cbase + 8 * j, n = n0 + c;
        if (n >= d) continue;
        const float u = acc[i][j] + bv[j];
        if (us_out) us_out[l * slab + g * d + n] = u;
        // two roundings, as torch's multiply and add (no fused multiply-add)
        xn[g * d + n] = __fadd_rn(xlt[r * kEld + c], __fmul_rn(x0t[r * kEld + c], u));
      }
    }
    __syncthreads();  // the staged tiles are read before the next layer's chunks land
    trace(3 + 2 * l);
    if (l + 1 < layers) {  // our columns of X_{l+1} out, everyone's in, before layer l + 1
      cluster_arrive();
      cluster_wait();
    }
  }
  trace(14);
}

// ---- bf16: wgmma + TMA -------------------------------------------------------
struct BfBars {
  uint64_t* full;   // [stages] a W chunk landed
  uint64_t* empty;  // [stages] the consumers are done with a W chunk
  uint64_t* ready;  // [2] X_{l+1} in: our columns written, the others' pushed
  uint64_t* free_;  // [1] every block is done with its product of the layer
  uint64_t* x0;     // [1] the X_0 tile landed (TMA)
};

// W chunk c (layer c / nk, depth (c % nk) * 64, this block's 128 rows) by the
// producer warp, element by element, into the swizzled layout TMA would write.
__device__ __forceinline__ void load_w_bf16_elements(const bf16* __restrict__ w,
                                                     unsigned char* dst, int c,
                                                     int nk, int n0, int d) {
  const int l = c / nk, k0 = (c - l * nk) * kBfKc;
  const unsigned short* wl = reinterpret_cast<const unsigned short*>(w) +
                             static_cast<long long>(l) * d * d;
  const int lane = threadIdx.x & 31;
  for (int u = lane; u < kCols * 8; u += 32) {
    const int row = u >> 3, q = u & 7, n = n0 + row;
    unsigned short e[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int k = k0 + q * 8 + t;
      e[t] = (n < d && k < d) ? wl[static_cast<long long>(n) * d + k] : 0;
    }
    uint4 v;
    memcpy(&v, e, sizeof(v));
    *reinterpret_cast<uint4*>(dst + row * 128 + ((q ^ (row & 7)) << 4)) = v;
  }
}

// Push our 128 columns of the X tile at `tile` (two whole 64-column chunks,
// 16 KB, at the same offsets in every block: the tiles swizzle identically)
// into every other block of the cluster by bulk copies between shared
// memories, each landing on that block's barrier `bar` (complete_tx).
__device__ __forceinline__ void push_columns(const unsigned char* tile, int n0, int csize,
                                             int own, uint64_t* bar) {
  const uint32_t src = smem_u32(tile + (n0 >> 6) * kChunkBytes);
  for (int q = 0; q < csize; ++q) {
    if (q == own) continue;
    asm volatile(
        "{\n.reg .b32 dst, rb;\n"
        "mapa.shared::cluster.u32 dst, %0, %2;\n"
        "mapa.shared::cluster.u32 rb, %1, %2;\n"
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
        " [dst], [%0], %3, [rb];\n}\n" ::"r"(src), "r"(smem_u32(bar)), "r"(q),
        "r"(2 * kChunkBytes)
        : "memory");
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kBfThreads, 2) cross_net_bf16(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const bf16* __restrict__ x0,
    const bf16* __restrict__ w, const bf16* __restrict__ bias, bf16* __restrict__ y,
    bf16* __restrict__ xs_out, bf16* __restrict__ us_out, int batch, int d, int dp,
    int layers, int stages, int x_buffers) {
  // the swizzled tiles need 1024-byte alignment, which the dynamic
  // shared-memory window has at its start (no static shared memory here)
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) % 1024 != 0) __trap();
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const int n0 = static_cast<int>(cluster.block_rank()) * kCols;
  const int nk = dp / kBfKc, total = layers * nk;
  const int xbytes = nk * kChunkBytes;  // one X tile
  unsigned char* xt = smem;
  unsigned char* ring = xt + x_buffers * xbytes;
  unsigned char* x0s = ring + stages * kWChunkBytes;  // our X_0 columns, swizzled
  bf16* bsm = reinterpret_cast<bf16*>(x0s + 2 * kChunkBytes);  // [2][kCols] our bias,
                                                                 // by layer parity
  uint64_t* bar = reinterpret_cast<uint64_t*>(bsm + 2 * kCols);
  BfBars bars{bar, bar + stages, bar + 2 * stages, bar + 2 * stages + 2,
              bar + 2 * stages + 3};
  const long long r0 = static_cast<long long>(blockIdx.x / csize) * kBfRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars.full[s], kTma ? 1 : 32);
      mbar_init(&bars.empty[s], 4);  // a consumer warp each
    }
    mbar_init(&bars.ready[0], 1);  // our arrive.expect_tx; the bytes come by push
    mbar_init(&bars.ready[1], 1);
    mbar_init(bars.free_, 4 * csize);  // a consumer warp of each block
    mbar_init(bars.x0, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  trace(0);
  cluster.sync();  // barriers ready before any block of the cluster arrives

  if (warp == 4) {  // the producer warp: X_0, then W chunks into the ring, across layers
    if (kTma && lane == 0) {  // rows past the batch and columns past D read as zero
      mbar_expect_tx(bars.x0, nk * kChunkBytes);
      for (int kc = 0; kc < nk; ++kc)
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(xt + kc * kChunkBytes)),
            "l"(reinterpret_cast<uint64_t>(&xmap)), "r"(kc * kBfKc),
            "r"(static_cast<int>(r0)), "r"(smem_u32(bars.x0))
            : "memory");
    }
    for (int c = 0; c < total; ++c) {
      const int s = c % stages;
      const unsigned phase = (c / stages) & 1;
      unsigned char* dst = ring + s * kWChunkBytes;
      if (kTma) {
        if (lane == 0) {
          mbar_wait(&bars.empty[s], phase ^ 1);
          mbar_expect_tx(&bars.full[s], kWChunkBytes);
          const int l = c / nk, k0 = (c - l * nk) * kBfKc;
          asm volatile(
              "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
              " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
              "l"(reinterpret_cast<uint64_t>(&wmap)), "r"(k0), "r"(n0), "r"(l),
              "r"(smem_u32(&bars.full[s]))
              : "memory");
        }
      } else {
        mbar_wait(&bars.empty[s], phase ^ 1);
        load_w_bf16_elements(w, dst, c, nk, n0, d);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&bars.full[s]);
      }
    }
    return;
  }

  // the consumer warpgroup: X_0 tile, every column, zero past the batch and D
  const int tid = threadIdx.x;
  if (kTma) {
    mbar_wait(bars.x0, 0);
  } else {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(x0);
    for (int u = tid; u < kBfRows * dp / 8; u += 128) {
      const int r = u / (dp / 8), k = (u - r * (dp / 8)) * 8;
      const long long g = r0 + r;
      unsigned short e[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        e[t] = (g < batch && k + t < d) ? src[g * d + k + t] : 0;
      uint4 v;
      memcpy(&v, e, sizeof(v));
      *reinterpret_cast<uint4*>(xt + x_offset(r, k)) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }
  // the block's columns of X_0, for the epilogues
  for (int u = tid; u < kBfRows * kCols / 8; u += 128) {
    const int r = u >> 4, q = (u & 15) * 8;
    *reinterpret_cast<uint4*>(x0s + x_offset(r, q)) =
        *reinterpret_cast<const uint4*>(xt + x_offset(r, n0 + q));
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  trace(1);

  // this thread's accumulator d[4j + 2h + e]: row 16 warp + lane / 4 + 8h,
  // column 8j + 2 (lane % 4) + e of the block's slice
  const int rw = 16 * warp + (lane >> 2), cw = 2 * (lane & 3);
  const bool pairs = (d & 1) == 0;  // 4-byte stores of column pairs
  float acc[64];
  int c = 0;
  for (int l = 0; l < layers; ++l) {
    unsigned char* xcur = xt + (x_buffers == 2 ? (l & 1) : 0) * xbytes;
    if (xs_out) {
      bf16* dst = xs_out + static_cast<long long>(l) * batch * d;
      if (kTma) {  // d % 8 == 0: 16-byte pieces
        for (int u = tid; u < kBfRows * kCols / 8; u += 128) {
          const int r = u >> 4, n = n0 + (u & 15) * 8;
          const long long g = r0 + r;
          if (g < batch && n < d)
            *reinterpret_cast<uint4*>(dst + g * d + n) =
                *reinterpret_cast<const uint4*>(xcur + x_offset(r, n));
        }
      } else {
        for (int e = tid; e < kBfRows * kCols; e += 128) {
          const int r = e >> 7, n = n0 + (e & (kCols - 1));
          const long long g = r0 + r;
          if (g < batch && n < d)
            dst[g * d + n] = *reinterpret_cast<const bf16*>(xcur + x_offset(r, n));
        }
      }
    }
    // the block's bias columns of layer l, staged under the product
    bsm[(l & 1) * kCols + tid] = n0 + tid < d ? bias[static_cast<long long>(l) * d + n0 + tid]
                                              : __float2bfloat16_rn(0.f);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc, ++c) {
      const int s = c % stages;
      mbar_wait(&bars.full[s], (c / stages) & 1);
      wgmma_fence();
      const uint32_t a0 = smem_u32(xcur + kc * kChunkBytes);
      const uint32_t b0 = smem_u32(ring + s * kWChunkBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n128k16(acc, desc_sw128(a0 + 32 * ks), desc_sw128(b0 + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(&bars.empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[prev]);
    // done with X_l: a block may push into our tile once all are (one tile:
    // every layer; two: the last, before the blocks may leave)
    if (lane == 0 && (x_buffers == 1 || l == layers - 1))
      for (unsigned q = 0; q < csize; ++q) mbar_arrive_remote(bars.free_, q);
    trace(2 + 2 * l);

    // epilogue: U_l out; xn[j][h] holds this thread's X_{l+1} pair. The
    // product is exact in f32, so the bf16x2 multiply rounds as torch's
    // does; the sum is rounded to f32 and then to bf16, as torch's is.
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the bias is in
    const __nv_bfloat162* bl = reinterpret_cast<const __nv_bfloat162*>(bsm + (l & 1) * kCols);
    uint32_t xn[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + cw;
      const __nv_bfloat162 bv = bl[(8 * j + cw) / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 8 * h;
        const long long g = r0 + r;
        const __nv_bfloat162 u = __floats2bfloat162_rn(acc[4 * j + 2 * h] + __low2float(bv),
                                                       acc[4 * j + 2 * h + 1] + __high2float(bv));
        const __nv_bfloat162 xl =
            *reinterpret_cast<const __nv_bfloat162*>(xcur + x_offset(r, n));
        const __nv_bfloat162 p = __hmul2(
            *reinterpret_cast<const __nv_bfloat162*>(x0s + x_offset(r, n - n0)), u);
        const __nv_bfloat162 x =
            __floats2bfloat162_rn(__fadd_rn(__low2float(xl), __low2float(p)),
                                  __fadd_rn(__high2float(xl), __high2float(p)));
        memcpy(&xn[j][h], &x, 4);
        if (us_out && g < batch && n < d) {
          bf16* dst = us_out + (static_cast<long long>(l) * batch + g) * d + n;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = u;
          } else {
            dst[0] = __low2bfloat16(u);
            if (n + 1 < d) dst[1] = __high2bfloat16(u);
          }
        }
      }
    }
    if (l == layers - 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + cw;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long g = r0 + rw + 8 * h;
          if (g >= batch || n >= d) continue;
          bf16* dst = y + g * d + n;
          if (pairs) {
            *reinterpret_cast<uint32_t*>(dst) = xn[j][h];
          } else {
            __nv_bfloat162 v;
            memcpy(&v, &xn[j][h], 4);
            dst[0] = __low2bfloat16(v);
            if (n + 1 < d) dst[1] = __high2bfloat16(v);
          }
        }
      }
      // no block leaves while another may still write into its shared
      // memory: every block has arrived on our barrier (at L = 1 too), and
      // our last push has landed once every block is done with its last
      // product
      mbar_wait_cluster(bars.free_, x_buffers == 1 ? l & 1 : 0);
      trace(3 + 2 * l);
      trace(14);
      break;
    }
    // the exchange: our columns of X_{l+1} into our next tile, then pushed
    // into every other block's, theirs into ours
    unsigned char* xnext = xt + (x_buffers == 2 ? ((l + 1) & 1) : 0) * xbytes;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + cw;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(xnext + x_offset(rw + 8 * h, n)) = xn[j][h];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the push and wgmma
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(&bars.ready[l & 1], (csize - 1) * 2 * kChunkBytes);
      // one tile: every block is done reading the X_l we overwrite
      if (x_buffers == 1) mbar_wait_cluster(bars.free_, l & 1);
      push_columns(xnext, n0, static_cast<int>(csize), n0 / kCols, &bars.ready[l & 1]);
    }
    mbar_wait_cluster(&bars.ready[l & 1], (l >> 1) & 1);
    trace(3 + 2 * l);
  }
}

// ---- host --------------------------------------------------------------------
size_t smem_f32() {
  return 4 * static_cast<size_t>(kF32Stages) * (kF32Rows + kCols) * (kF32Kc + 4);
}

size_t smem_bf16(int dp, int stages, int x_buffers) {
  return static_cast<size_t>(x_buffers) * kBfRows * dp * 2 +
         static_cast<size_t>(stages) * kWChunkBytes + 2 * kChunkBytes + 2 * kCols * 2 + 128;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The dynamic shared memory a kernel may take is raised to the most any plan
// has asked of it, once a size, not on every launch (the other sources keep
// theirs in a static): a record a kernel, for the four kernels here.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  constexpr int kKernels = 4;
  static const void* kernels[kKernels] = {};
  static size_t allowed[kKernels] = {};
  int i = 0;
  while (i < kKernels && kernels[i] != nullptr && kernels[i] != kernel) ++i;
  if (i < kKernels && kernels[i] == kernel && smem <= allowed[i]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && i < kKernels) {
    kernels[i] = kernel;
    allowed[i] = smem;
  }
  return err;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int grid, int threads, int cluster,
                           size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x0 (batch, d), w (layers, d, d), b (layers, d), y (batch, d); xs and us are
// (layers, batch, d) or null. All contiguous, one dtype (is_bf16 ? bf16 : f32).
// scratch: (2, batch, d) f32 where f32 runs more than one layer without xs.
// The plan (ops/cross.py:plan): tile_rows rows a cluster of `cluster` blocks,
// `grid` blocks, `smem` bytes a block, a ring of `stages` W chunks,
// x_buffers X tiles (bf16), and vector: W and x0 in 16-byte pieces (TMA for
// bf16).
// A plan that does not fit the shapes returns cudaErrorInvalidValue.
extern "C" int map_tpu_cross_net(const void* x0, const void* w, const void* b,
                                 void* y, void* xs, void* us, void* scratch, int batch, int d,
                                 int layers, int is_bf16, int tile_rows, int cluster,
                                 int grid, int smem, int stages, int x_buffers,
                                 int vector, void* stream) {
  if (batch <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const int dp = (d + kCols - 1) / kCols * kCols;
  const int size = is_bf16 ? 2 : 4;
  const bool aligned = (d * size) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x0) % 16 == 0;
  const int tiles = tile_rows > 0 ? (batch + tile_rows - 1) / tile_rows : 0;
  const size_t need = is_bf16 ? smem_bf16(dp, stages, x_buffers) : smem_f32();
  const bool ok = layers > 0 && cluster == dp / kCols && cluster <= kMaxCluster &&
                  grid == tiles * cluster && static_cast<size_t>(smem) >= need &&
                  (!vector || aligned) &&
                  (is_bf16 ? tile_rows == kBfRows && stages >= 2 && stages <= 4 &&
                                 (x_buffers == 1 || x_buffers == 2)
                           : tile_rows == kF32Rows && stages == kF32Stages &&
                                 x_buffers == 1 &&
                                 (xs != nullptr || layers == 1 || scratch != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (!is_bf16) {
    const float *fx0 = static_cast<const float*>(x0), *fw = static_cast<const float*>(w),
                *fb = static_cast<const float*>(b);
    float *fy = static_cast<float*>(y), *fxs = static_cast<float*>(xs),
          *fus = static_cast<float*>(us), *fscratch = static_cast<float*>(scratch);
    const cudaError_t err =
        vector ? launch_cluster(&cross_net_f32<true>, grid, kF32Threads, cluster, bytes, s, fx0,
                                fw, fb, fy, fxs, fus, fscratch, batch, d, dp, layers)
               : launch_cluster(&cross_net_f32<false>, grid, kF32Threads, cluster, bytes, s,
                                fx0, fw, fb, fy, fxs, fus, fscratch, batch, d, dp, layers);
    return static_cast<int>(err);
  }
  CUtensorMap wmap, xmap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  if (vector) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(layers)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                   static_cast<cuuint64_t>(d) * d * 2};
    const cuuint32_t box[3] = {kBfKc, kCols, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(batch)};
    const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(d) * 2};
    const cuuint32_t xbox[2] = {kBfKc, kBfRows};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x0), xdims,
               xstrides, xbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16 *hx0 = static_cast<const bf16*>(x0), *hw = static_cast<const bf16*>(w),
             *hb = static_cast<const bf16*>(b);
  bf16 *hy = static_cast<bf16*>(y), *hxs = static_cast<bf16*>(xs), *hus = static_cast<bf16*>(us);
  cudaError_t err =
      vector ? launch_cluster(&cross_net_bf16<true>, grid, kBfThreads, cluster, bytes, s,
                              wmap, xmap, hx0, hw, hb, hy, hxs, hus, batch, d, dp, layers, stages,
                              x_buffers)
             : launch_cluster(&cross_net_bf16<false>, grid, kBfThreads, cluster, bytes, s,
                              wmap, xmap, hx0, hw, hb, hy, hxs, hus, batch, d, dp, layers, stages,
                              x_buffers);
  return static_cast<int>(err);
}

#ifdef MAP_TPU_CROSS_TRACE
extern "C" int map_tpu_cross_trace(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_cross_trace, sizeof(g_cross_trace)));
}
#endif
