// K8: inclusive prefix sum over axis 0 of a row-major (n, w) f32 array,
//   out[r, c] = x[0, c] + x[1, c] + ... + x[r, c],   for any n and w <= 128,
// with a fixed association, so every call gives the same bits.
//
// Replaces map_tpu/ops/pallas_scan.py:block_cumsum, a sequential grid over
// 512-row blocks whose carry persists in scratch from one grid step to the
// next. Hopper's blocks run in parallel and in no order, so the carry becomes
// a pass of its own. Three launches:
//   1. tile_sums: a block per tile of 32 * nseg rows; thread (s, c) sums the
//      32 rows of segment s in column c in order, then the segment sums are
//      added in order into the tile's sum of each column;
//   2. carry_scan: a warp per column scans the tiles' sums: each lane sums a
//      run of consecutive tiles in order, the 32 run sums are scanned with a
//      fixed shuffle ladder, and each lane writes its tiles' carries, each
//      the lane's exclusive prefix plus the run's own prefix from 0;
//   3. tile_scan: thread (s, c) holds its segment's 32 values in registers,
//      takes the tile's carry plus the earlier segments' sums (in order) as
//      its base, and writes base + the segment's own prefix from 0, row by
//      row.
// No decoupled look-back: its association would depend on timing. Scratch
// (the tiles' sums and carries) comes from the caller.
//
// Bound: device-memory bytes, n * w * 4 read and written once: 0.059 ms at
// 3.35 TB/s for the per-position MFP fold's (745,472, 33) stream. Phases 1
// and 3 each read x once (the second read mostly from L2 at the fold's
// sizes); phase 2 touches n / 32 / nseg * w values twice.
//
// Accuracy: every partial sum starts from 0 at its own level (a segment's
// rows, a run's tiles) and meets the larger prefix once, so a value carries
// about 5 + 1 + nseg + 1 roundings at the magnitude of the prefix (the
// shuffle ladder, the run's prefix, the segment sums, the row's own prefix)
// and the in-order sums of at most 32 rows or one run of tiles at their own,
// smaller magnitude; a running sum would round n times at the prefix's.
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 32;      // rows a thread sums in order
constexpr int kMaxSegs = 8;   // segments per tile
constexpr int kThreads = 256; // >= nseg * w

int segments_per_tile(int w) {
  const int s = kThreads / w;
  return s < 1 ? 1 : (s > kMaxSegs ? kMaxSegs : s);
}

__global__ void __launch_bounds__(kThreads)
tile_sums(const float* __restrict__ x, float* __restrict__ sums, long long n, int w,
          int nseg) {
  __shared__ float seg[kThreads];
  const int t = threadIdx.x;
  const int s = t / w, c = t - s * w;
  const long long row0 = static_cast<long long>(blockIdx.x) * kSeg * nseg + s * kSeg;
  if (s < nseg) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const long long r = row0 + i;
      if (r < n) acc = __fadd_rn(acc, __ldg(x + r * w + c));
    }
    seg[t] = acc;
  }
  __syncthreads();
  if (t < w) {
    float total = seg[t];
    for (int k = 1; k < nseg; ++k) total = __fadd_rn(total, seg[k * w + t]);
    sums[static_cast<long long>(blockIdx.x) * w + t] = total;
  }
}

// one warp per column: carries[b, c] = sums[0, c] + ... + sums[b - 1, c]
__global__ void carry_scan(const float* __restrict__ sums, float* __restrict__ carries,
                           long long tiles, int w) {
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const long long run = (tiles + 31) / 32;
  const long long b0 = lane * run;
  const long long b1 = b0 + run < tiles ? b0 + run : tiles;
  float local = 0.f;
  for (long long b = b0; b < b1; ++b) local = __fadd_rn(local, sums[b * w + c]);
  // inclusive scan of the 32 run sums, then shifted one lane up
  float incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = __fadd_rn(up, incl);
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) base = 0.f;
  float within = 0.f;  // the run's exclusive prefix, from 0
  for (long long b = b0; b < b1; ++b) {
    carries[b * w + c] = __fadd_rn(base, within);
    within = __fadd_rn(within, sums[b * w + c]);
  }
}

__global__ void __launch_bounds__(kThreads)
tile_scan(const float* __restrict__ x, const float* __restrict__ carries,
          float* __restrict__ out, long long n, int w, int nseg) {
  __shared__ float seg[kThreads];
  const int t = threadIdx.x;
  const int s = t / w, c = t - s * w;
  const long long row0 = static_cast<long long>(blockIdx.x) * kSeg * nseg + s * kSeg;
  float v[kSeg];
  if (s < nseg) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const long long r = row0 + i;
      v[i] = r < n ? __ldg(x + r * w + c) : 0.f;
      acc = __fadd_rn(acc, v[i]);
    }
    seg[t] = acc;
  }
  __syncthreads();
  if (s < nseg) {
    float base = carries[static_cast<long long>(blockIdx.x) * w + c];
    for (int k = 0; k < s; ++k) base = __fadd_rn(base, seg[k * w + c]);
    float local = 0.f;  // the segment's own prefix, from 0
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const long long r = row0 + i;
      local = __fadd_rn(local, v[i]);
      if (r < n) out[r * w + c] = __fadd_rn(base, local);
    }
  }
}

}  // namespace

// x, out (n, w) f32 contiguous, w in [1, 128]; scratch at least
// 2 * ceil(n / 32) * w floats (the tiles' sums, then their carries).
extern "C" int map_tpu_block_cumsum(const void* x, void* out, void* scratch,
                                    long long n, int w, void* stream) {
  if (w < 1 || w > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int nseg = segments_per_tile(w);
  const long long tiles = (n + kSeg * nseg - 1) / (kSeg * nseg);
  float* sums = static_cast<float*>(scratch);
  float* carries = sums + tiles * w;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_sums<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const float*>(x), sums, n, w, nseg);
  carry_scan<<<w, 32, 0, st>>>(sums, carries, tiles, w);
  tile_scan<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const float*>(x), carries, static_cast<float*>(out), n, w, nseg);
  return static_cast<int>(cudaGetLastError());
}
