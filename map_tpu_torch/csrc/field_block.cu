// K6: the field-block embedding kernels of the hybrid lookup, every small
// field in one launch per direction over a static list of (field, 512-row
// tile) pairs (map_tpu_torch/ops/field_gather.py builds it).
//
//   K6b scatter: for each unique tile, out_tile[row, :] = sum of g[b, pos, :]
//                over every pair (pos, tile) and every b with
//                phys[pos, b] == tile_row0 + row                        (f32)
//   K6a gather:  out[b, pos, :] = table[phys[pos, b], :] when phys[pos, b]
//                lies in one of field pos's tiles, else 0
//
// Replaces map_tpu/ops/pallas_field_gather.py:field_block_scatter and
// :field_block_gather. The TPU kernels build a (512, B) one-hot in VMEM and
// run three bf16 MXU passes (hi / lo / lo2 split) per pair, because the TPU
// has no fast scattered writes. Hopper has them, so none of that carries
// over.
//
// K6b design: one block per unique tile (and per 16 columns of W). A thread
// owns 8 rows of the tile and 4 columns, as 8 float4 sums in registers; row
// r goes to warp r % 8, so the few rows of a tiny field (4-8 ids, each hit
// by about 1000 of the batch's rows) land on different warps. For each pair
// of its tile, the block stages 512 ids at a time in shared memory, with the
// g rows that hit the tile (bf16 or f32 as they arrive, up-cast to f32);
// each warp ballots the hits on its rows and walks them in order of b. So
// each row is summed in order of (pair, b) from 0.0 in f32: no atomics, the
// same bits every run, and for a row of one field the order of b, which is
// the order in which K3 (scatter_add.cu) sums the row's segment of the
// stably sorted ids. The tile is written to a compact (U, 512, W) stack, or
// added onto a dense (R, W) gradient (the hybrid backward adds after K3,
// which writes every row); the last tile may run past R, and rows past R
// are not written.
//
// Bound: device-memory bytes, the g rows of the small fields read once
// (B * Fs * W * 2 in bf16), the ids read once, the tiles written (added:
// read and written) once: about 5-8 MB at the training shape (B = 4096, 21
// small fields, 65 tiles), 2-3 microseconds at 3.35 TB/s. The in-order sum
// of a tiny field's rows (a chain of about 1000 dependent adds per row) is
// what the kernel pays instead.
//
// K6a design: E/4 threads per (b, field) row, one float4 each, grid-stride,
// as K4 (embedding_gather.cu); ids outside the field's tiles give zeros.
//
// Both take W a multiple of 4 and 16-byte aligned tensors (the wrapper
// checks). Ids must be -1 or in [0, R); the kernels do not check it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;                          // ids staged per pass
constexpr int kCols = 16;                            // columns of a block
constexpr int kGroups = kCols / 4;                   // float4 groups of a block
constexpr int kRowsPerThread = kTile / (kWarps * 8);  // 8
constexpr long long kMaxBlocks = 65535;

__device__ __forceinline__ float4 load4(const float* g) {
  return __ldg(reinterpret_cast<const float4*>(g));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* g) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(g));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// grid (U, ceil(w / kCols)); block kThreads
template <typename G>
__global__ void __launch_bounds__(kThreads)
field_block_scatter_kernel(const G* __restrict__ g, const int* __restrict__ phys,
                           const int* __restrict__ tile_row0,
                           const int* __restrict__ pair_off,
                           const int* __restrict__ pair_pos, float* __restrict__ out,
                           int b, int fs, int w, long long r, int add) {
  __shared__ int rel_s[kChunk];
  __shared__ float4 g_s[kChunk][kGroups];
  const int slot = blockIdx.x;
  const long long row0 = tile_row0[slot];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rs = lane >> 2;  // which 8-row group of the warp's rows
  const int cg = lane & 3;   // which float4 of the block's 16 columns
  const int col = blockIdx.y * kCols + cg * 4;
  const long long ld = static_cast<long long>(fs) * w;  // g's row stride

  float4 acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int p = pair_off[slot]; p < pair_off[slot + 1]; ++p) {
    const int pos = pair_pos[p];
    const int* ids = phys + static_cast<long long>(pos) * b;
    const G* gp = g + static_cast<long long>(pos) * w + blockIdx.y * kCols;
    for (int b0 = 0; b0 < b; b0 += kChunk) {
      const int n = min(kChunk, b - b0);
      __syncthreads();  // the previous chunk is read
      for (int item = threadIdx.x; item < kChunk * kGroups; item += kThreads) {
        const int i = item / kGroups;
        const int c = item - i * kGroups;
        int rel = -1;
        if (i < n) {
          const int id = __ldg(ids + b0 + i);
          const long long d = static_cast<long long>(id) - row0;
          if (id >= 0 && d >= 0 && d < kTile) rel = static_cast<int>(d);
        }
        if (c == 0) rel_s[i] = rel;
        if (rel >= 0 && blockIdx.y * kCols + c * 4 < w) {
          g_s[i][c] = load4(gp + (b0 + i) * ld + c * 4);
        }
      }
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int rel = rel_s[i0 + lane];
        unsigned hits = __ballot_sync(0xffffffffu, rel >= 0 && (rel & 7) == warp);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const int row = __shfl_sync(0xffffffffu, rel, src);
          if (((row >> 3) & 7) == rs) {
            const float4 v = g_s[i0 + src][cg];
            const int k = row >> 6;
#pragma unroll
            for (int q = 0; q < kRowsPerThread; ++q) {
              if (q == k) add4(acc[q], v);
            }
          }
        }
      }
    }
  }

  if (col >= w) return;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = q * 64 + rs * 8 + warp;
    if (add) {
      const long long grow = row0 + row;
      if (grow < r) {
        float4* d = reinterpret_cast<float4*>(out + grow * w + col);
        float4 v = *d;
        add4(v, acc[q]);
        *d = v;
      }
    } else {
      *reinterpret_cast<float4*>(
          out + (static_cast<long long>(slot) * kTile + row) * w + col) = acc[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
field_block_gather_kernel(const float* __restrict__ table, const int* __restrict__ phys,
                          const int* __restrict__ win_lo, const int* __restrict__ win_hi,
                          float* __restrict__ out, int b, int fs, int w) {
  const int groups = w >> 2;
  const long long items = static_cast<long long>(b) * fs * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const long long row = i / groups;  // b * fs + pos: out's (b, pos) row
    const int c = static_cast<int>(i - row * groups);
    const int bb = static_cast<int>(row / fs);
    const int pos = static_cast<int>(row - static_cast<long long>(bb) * fs);
    const int id = __ldg(phys + static_cast<long long>(pos) * b + bb);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (id >= 0 && id >= __ldg(win_lo + pos) && id < __ldg(win_hi + pos)) {
      v = load4(table + static_cast<long long>(id) * w + 4 * c);
    }
    reinterpret_cast<float4*>(out)[i] = v;
  }
}

}  // namespace

// g (b, fs * w) f32 or bf16; phys (fs, b) int32, -1 = skip; tile_row0 (u,)
// int32, the first row of each unique tile; pair_off (u + 1,) and pair_pos
// (pairs,) int32, the field positions of tile s's pairs at
// pair_pos[pair_off[s]:pair_off[s + 1]]. add = 0: out is the (u, 512, w)
// stack, every element written; add = 1: out is the dense (r, w) gradient,
// each tile added onto its rows below r. All contiguous, w % 4 == 0.
extern "C" int map_tpu_field_block_scatter(const void* g, const void* phys,
                                           const void* tile_row0, const void* pair_off,
                                           const void* pair_pos, void* out, int b, int fs,
                                           int w, long long r, int u, int g_bf16, int add,
                                           void* stream) {
  if (u <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(u), static_cast<unsigned>((w + kCols - 1) / kCols));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ph = static_cast<const int*>(phys);
  const int* t0 = static_cast<const int*>(tile_row0);
  const int* po = static_cast<const int*>(pair_off);
  const int* pp = static_cast<const int*>(pair_pos);
  float* o = static_cast<float*>(out);
  if (g_bf16) {
    field_block_scatter_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), ph, t0, po, pp, o, b, fs, w, r, add);
  } else {
    field_block_scatter_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), ph, t0, po, pp, o, b, fs, w, r, add);
  }
  return static_cast<int>(cudaGetLastError());
}

// table (r, w) f32; phys (fs, b) int32, -1 = skip; win_lo / win_hi (fs,)
// int32, the rows [lo, hi) of field pos's tiles; out (b, fs * w) f32, every
// element written. All contiguous, w % 4 == 0.
extern "C" int map_tpu_field_block_gather(const void* table, const void* phys,
                                          const void* win_lo, const void* win_hi, void* out,
                                          int b, int fs, int w, void* stream) {
  const long long items = static_cast<long long>(b) * fs * (w / 4);
  if (items <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  field_block_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(phys),
      static_cast<const int*>(win_lo), static_cast<const int*>(win_hi),
      static_cast<float*>(out), b, fs, w);
  return static_cast<int>(cudaGetLastError());
}
