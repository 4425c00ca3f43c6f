// K8: inclusive prefix sum over axis 0 of a row-major (n, w) f32 array,
//   out[r, c] = x[0, c] + x[1, c] + ... + x[r, c],   for any n and w <= 128,
// with a fixed association, so every call gives the same bits.
//
// Replaces map_tpu/ops/pallas_scan.py:block_cumsum, a sequential grid over
// 512-row blocks whose carry persists in scratch from one grid step to the
// next. Hopper's blocks run in parallel and in no order, so the carry needs
// the other blocks' sums; a scan split into launches (sums, carries, scan)
// reads x twice, and the MFP fold's x (98 MB) is larger than the 50 MB L2.
//
// Bound: device-memory bytes, n * w * 4 read and written once: 0.059 ms at
// 3.35 TB/s for the per-position MFP fold's (745,472, 33) stream.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be resident at once rather than let a grid
// barrier wait forever) of `grid` blocks, one an SM, in `rounds` rounds; the
// plan (map_tpu_torch/ops/scan.py:plan) fixes every size. Block b takes tile
// r * grid + b, `tile_rows` consecutive rows (up to about 200 KB, so the
// per-position fold takes 4 rounds), in round r:
//   1. the tile comes into shared memory by cp.async: it is contiguous, so
//      in 16-byte pieces whatever w (tile_rows is a multiple of 4) where x
//      and out are 16-byte aligned, else in 4-byte ones;
//   2. thread (s, c) sums rows [s * seg_rows, (s + 1) * seg_rows) of
//      column c in order from 0; threads c add the segments' sums in order
//      into the tile's sum of column c and publish it (`agg`, one row a
//      tile, never reused in the launch, so no barrier guards its reuse);
//   3. the grid crosses a barrier;
//   4. thread (p, c) sums run p of the round's tile sums (part_tiles
//      consecutive tiles) in order from 0, noting the sum before its own
//      tile; threads c walk the runs in order from the round's base, taking
//      base + the in-run prefix as the tile's carry where its run comes,
//      and keep the base after the last run for the next round. Every block
//      walks the same sums in the same order, so all agree on the base;
//   5. thread (s, c) adds the earlier segments' sums to the carry in order,
//      and replaces each row of its segment, in place, by that base + the
//      segment's own in-order prefix through the row; the tile leaves in
//      16-byte streaming stores, and the next round's tile is requested.
// No decoupled look-back: its association would depend on timing. Built and
// measured slower (PERF.md): more tile buffers with the next rounds'
// tiles in flight, TMA bulk copies, a barrier-free wait on published sums
// tagged with their round, one round of lookahead, loads batched ahead of
// the in-order adds. Under the bulk traffic every dependent access to L2
// (the barrier, the carry's reads) takes microseconds, so fewer rounds did
// better than more overlap.
//
// Accuracy: every partial sum starts from 0 at its own level (a segment's
// rows, a run's tiles) and meets the larger prefix once, so a value carries
// about rounds * (runs + 1) + segs + 1 roundings at the magnitude of the
// prefix and the in-order sums of at most seg_rows rows or part_tiles tiles
// at their own, smaller magnitude; a running sum would round n times at the
// prefix's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;   // ops/scan.py THREADS
constexpr int kMaxWidth = 128;
constexpr int kSmemOptin = 232448;

struct ScanPlan {
  long long n, tiles;
  int w, tile_rows, grid, rounds, segs, seg_rows, part_tiles, vector;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int tile_rows_of(long long tile_idx, const ScanPlan& P) {
  const long long left = P.n - tile_idx * P.tile_rows;
  return left < P.tile_rows ? static_cast<int>(left) : P.tile_rows;
}

// tile `tile_idx` (if any) of x into `tile` by cp.async
__device__ __forceinline__ void request_tile(float* tile, const float* __restrict__ x,
                                             long long tile_idx, const ScanPlan& P) {
  if (tile_idx >= P.tiles) return;
  const long long count = static_cast<long long>(tile_rows_of(tile_idx, P)) * P.w;
  const float* src = x + tile_idx * P.tile_rows * P.w;
  long long done = 0;
  if (P.vector) {
    const long long n4 = count >> 2;
    for (long long i = threadIdx.x; i < n4; i += kThreads) cp_async16(tile + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (long long i = done + threadIdx.x; i < count; i += kThreads) cp_async4(tile + i, src + i);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
block_cumsum_rounds(const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ agg, const ScanPlan P) {
  extern __shared__ __align__(16) float smem[];
  const int w = P.w;
  float* tile = smem;                              // (tile_rows, w)
  float* seg = tile + P.tile_rows * w;             // (segs, w) segment sums
  float* part = seg + P.segs * w;                  // (segs, w) run sums
  float* carry_in = part + P.segs * w;             // (w) the in-run prefix
  float* carry = carry_in + w;                     // (w)
  float* base = carry + w;                         // (w) the prefix before the round
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int s = t / w, c = t - s * w;
  const bool active = s < P.segs;
  const int b = blockIdx.x;
  if (t < w) base[t] = 0.f;
  request_tile(tile, x, b, P);

  long long tile_idx = b;
  for (int r = 0; r < P.rounds; ++r, tile_idx += P.grid) {
    const bool has = tile_idx < P.tiles;
    const int rows = has ? tile_rows_of(tile_idx, P) : 0;
    const int r0 = s * P.seg_rows;
    const int r1 = r0 + P.seg_rows < rows ? r0 + P.seg_rows : rows;
    cp_async_wait_all();
    __syncthreads();
    // 2. the segments' sums, the tile's sum
    if (has && active) {
      float acc = 0.f;
      for (int i = r0; i < r1; ++i) acc = __fadd_rn(acc, tile[i * w + c]);
      seg[s * w + c] = acc;
    }
    __syncthreads();
    if (has && t < w) {
      float total = seg[t];
      for (int k = 1; k < P.segs; ++k) total = __fadd_rn(total, seg[k * w + t]);
      agg[tile_idx * w + t] = total;
    }
    // 3.
    grid.sync();
    // 4. the tile's carry from the round's tile sums, in runs
    const long long first = static_cast<long long>(r) * P.grid;
    const int count = P.tiles - first < P.grid ? static_cast<int>(P.tiles - first) : P.grid;
    const int runs = (count + P.part_tiles - 1) / P.part_tiles;
    if (active && s < runs) {
      const int j0 = s * P.part_tiles;
      const int j1 = j0 + P.part_tiles < count ? j0 + P.part_tiles : count;
      float acc = 0.f;
      for (int j = j0; j < j1; ++j) {
        if (j == b) carry_in[c] = acc;
        acc = __fadd_rn(acc, __ldcg(agg + (first + j) * w + c));
      }
      part[s * w + c] = acc;
    }
    __syncthreads();
    if (t < w) {
      const int mine = b / P.part_tiles;
      float run = base[t];
      for (int q = 0; q < runs; ++q) {
        if (q == mine) carry[t] = __fadd_rn(run, carry_in[t]);
        run = __fadd_rn(run, part[q * w + t]);
      }
      base[t] = run;
    }
    __syncthreads();
    // 5. the tile's scan, in place
    if (has && active) {
      float sb = carry[c];
      for (int k = 0; k < s; ++k) sb = __fadd_rn(sb, seg[k * w + c]);
      float local = 0.f;
      for (int i = r0; i < r1; ++i) {
        local = __fadd_rn(local, tile[i * w + c]);
        tile[i * w + c] = __fadd_rn(sb, local);
      }
    }
    __syncthreads();
    if (has) {
      const long long n_out = static_cast<long long>(rows) * w;
      float* dst = out + tile_idx * P.tile_rows * w;
      const long long n4 = P.vector ? n_out >> 2 : 0;
      for (long long i = t; i < n4; i += kThreads)
        __stcs(reinterpret_cast<float4*>(dst) + i, reinterpret_cast<const float4*>(tile)[i]);
      for (long long i = 4 * n4 + t; i < n_out; i += kThreads) __stcs(dst + i, tile[i]);
    }
    __syncthreads();
    request_tile(tile, x, tile_idx + P.grid, P);
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// x, out (n, w) f32 contiguous, w in [1, 128]; agg at least tiles * w
// floats. The plan (ops/scan.py:plan) is checked against the shape and the
// kernel's shared-memory layout; a plan that does not fit is refused.
extern "C" int map_tpu_block_cumsum(const void* x, void* out, void* agg, long long n, int w,
                                    int tile_rows, long long tiles, int grid, int rounds,
                                    int segs, int seg_rows, int part_tiles, int smem,
                                    int vector, void* stream) {
  const long long want_smem =
      4LL * (static_cast<long long>(tile_rows) * w + 2LL * segs * w + 3LL * w);
  if (w < 1 || w > kMaxWidth || n < 1 || tile_rows < 1 || tile_rows % 4 ||
      tiles != cdiv(n, tile_rows) || grid < 1 || grid > tiles ||
      rounds != cdiv(tiles, grid) || segs < 1 || static_cast<long long>(segs) * w > kThreads ||
      static_cast<long long>(seg_rows) * segs < tile_rows ||
      static_cast<long long>(part_tiles) * segs < grid || smem != want_smem ||
      smem > kSmemOptin ||
      (vector && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_cumsum_rounds, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ScanPlan P;
  P.n = n;
  P.tiles = tiles;
  P.w = w;
  P.tile_rows = tile_rows;
  P.grid = grid;
  P.rounds = rounds;
  P.segs = segs;
  P.seg_rows = seg_rows;
  P.part_tiles = part_tiles;
  P.vector = vector;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  float* ap = static_cast<float*>(agg);
  void* args[] = {&xp, &op, &ap, &P};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)block_cumsum_rounds, dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
