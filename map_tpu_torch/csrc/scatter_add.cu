// K3: dense embedding-gradient scatter-add,
//   out[v, :] = sum of grads[i, :] over every i with ids[i] == v   (f32)
// for a (V, E) table, from (N, E) row gradients in f32 or bf16. The wrapper
// (map_tpu_torch/ops/scatter.py) sorts the flat ids first (torch.sort,
// stable) and hands over the sorted ids and the permutation.
//
// Replaces map_tpu/ops/pallas_scatter.py:_scatter_add_pallas. The TPU kernel
// builds a (chunk, tile) pair list and folds duplicates with one-hot matmuls
// on the MXU because the TPU has no fast scattered writes; none of that
// carries over.
//
// The order of the sums is the contract: each touched row is summed in f32,
// from 0.0, with __fadd_rn, in the order of its segment of the stably sorted
// ids, which is index order (the order in which index_add_ on the CPU, and
// index_put_ with accumulate on the card, add them; K6b sums in the same
// order). Untouched rows are exactly 0. No sum is split or reordered, so the
// result does not depend on scheduling.
//
// Bound: device-memory bytes. The dense (V, E) f32 output dominates: 64.9 MB
// at the canonical table (1,013,519 x 16), against about 3.1 MB of bf16
// gradients and 1.2 MB of ids and permutation at the training shape
// (N = 4096 x 24), about 0.020 ms at 3.35 TB/s.
//
// Design, in two launches on the caller's stream:
// 1. scatter_rows_zero clears the whole output with 16-byte stores at the
//    memory rate, a few blocks per SM, each of which at once lets the next
//    launch start (programmatic dependent launch).
// 2. scatter_rows_segments walks the sorted stream, not the table, so the
//    rows that no id touches cost nothing more and no row needs a search.
//    Each warp owns a span of kSpan sorted positions and sums every segment
//    whose head (the first position of an id) lies in its span, to the
//    segment's end, even past the span. It streams positions in chunks of
//    kRows and keeps the loads off the add chain: cp.async brings a chunk's
//    sorted ids and permutation into shared memory 2 kStages chunks ahead,
//    and its gradient rows, in 16-byte pieces, kStages chunks ahead, once
//    the permutation is on chip. Each lane then sums one column over the
//    staged rows in order, so a duplicate costs a shared-memory read and an
//    add, not a memory round trip; a chunk inside one segment is one
//    unrolled chain of adds. The walk's first loads overlap the zero pass: it
//    waits for the zero pass only before its first store. A long segment
//    (MFP's <mask> id in about 25,000 rows, a tiny field's id in about 1,000)
//    runs at about three times the add chain's latency, as starting a chunk's
//    copies costs about as much as its adds (a producer warp could take the
//    copies over).
// Rows that are not whole 16-byte pieces (E not a multiple of 4 in f32, of
// 8 in bf16), or unaligned tensors, take a simple element-per-thread walk
// from each segment head, with its loads batched kBatch ahead of its adds.
//
// Ids must lie in [0, V): the kernel does not check them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kPer = 4;            // sorted positions per lane in a chunk
constexpr int kRows = 32 * kPer;   // sorted positions per chunk
constexpr int kStages = 2;         // gradient chunks in flight per warp
constexpr int kIdxSlots = 2 * kStages;
constexpr int kSpan = 64;          // positions whose segment heads a warp owns
constexpr int kTileCols = 16;      // columns one warp sums, one a lane
constexpr int kZeroThreads = 256;
constexpr long long kZeroBlocksPerSm = 4;
constexpr int kScalarThreads = 256;
constexpr int kBatch = 8;          // scalar path: loads in flight per thread
constexpr long long kMaxBlocks = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// copies 16 bytes from global to shared memory, zero-filling past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// a grid of a few blocks per SM, all resident at once: each block lets the
// segment walk, launched next as its programmatic dependent, start its loads
// at once
__global__ void __launch_bounds__(kZeroThreads)
scatter_rows_zero(float* __restrict__ out, long long count, bool vec) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    float4* o = reinterpret_cast<float4*>(out);
    for (long long i = first; i < count / 4; i += stride) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (long long i = first; i < count; i += stride) out[i] = 0.f;
  }
}

// one warp's staging area: 22 KB with f32 gradients, 14 KB with bf16
template <typename G>
struct WarpStage {
  static constexpr int kPieces = kTileCols * sizeof(G) / 16;  // 16-byte pieces a row
  int sorted[kIdxSlots][kRows];
  long long perm[kIdxSlots][kRows];
  uint4 grads[kStages][kRows][kPieces];
};

// one warp a block; grid (ceil(n / kSpan), ceil(E / kTileCols)), blockIdx.y
// the warp's column tile. A row's tile slice is whole 16-byte pieces: E is a
// multiple of 16 / sizeof(G).
template <typename G>
__global__ void __launch_bounds__(32)
scatter_rows_segments(const int* __restrict__ sorted, const long long* __restrict__ perm,
                      const G* __restrict__ grads, float* __restrict__ out,
                      long long n, int e) {
  using Stage = WarpStage<G>;
  constexpr int kPieces = Stage::kPieces;
  constexpr int kPieceCols = 16 / sizeof(G);
  __shared__ __align__(16) Stage sm;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const long long s = static_cast<long long>(blockIdx.x) * kSpan;
  if (s >= n) return;
  const long long span_end = s + kSpan < n ? s + kSpan : n;
  const int c0 = blockIdx.y * kTileCols;  // the tile's first column
  const int cols = min(kTileCols, e - c0);
  const int before = s > 0 ? __ldg(sorted + s - 1) : -1;
  const int last = __ldg(sorted + span_end - 1);

  // chunk c holds positions s + kRows c ..; positions past n are zero-filled
  auto fetch_idx = [&](int c) {
    const long long cs = s + static_cast<long long>(c) * kRows;
    if (cs >= n) return;
    const int slot = c % kIdxSlots;
#pragma unroll
    for (int q = lane; q < kRows / 4; q += 32) {  // 4 ids a copy
      const long long p = cs + 4 * q;
      const int bytes = p >= n ? 0 : static_cast<int>(min(16LL, (n - p) * 4));
      cp_async16(&sm.sorted[slot][4 * q], sorted + (bytes ? p : 0), bytes);
    }
#pragma unroll
    for (int q = lane; q < kRows / 2; q += 32) {  // 2 permutation entries a copy
      const long long p = cs + 2 * q;
      const int bytes = p >= n ? 0 : static_cast<int>(min(16LL, (n - p) * 8));
      cp_async16(&sm.perm[slot][2 * q], perm + (bytes ? p : 0), bytes);
    }
  };
  // needs chunk c's ids and permutation on chip; skips a chunk past the
  // span that the walk cannot reach. Lane copies piece u of rows
  // lane / kPieces + kLaneRows j; every permutation entry is read before
  // the first copy goes out.
  auto fetch_grads = [&](int c) {
    constexpr int kLaneRows = 32 / kPieces;
    const long long cs = s + static_cast<long long>(c) * kRows;
    if (cs >= n) return;
    const int islot = c % kIdxSlots;
    if (cs >= span_end && sm.sorted[islot][0] != last) return;
    const int u = lane % kPieces;
    if (u * kPieceCols >= cols) return;
    long long rows[kRows / kLaneRows];
#pragma unroll
    for (int j = 0; j < kRows / kLaneRows; ++j) rows[j] = sm.perm[islot][lane / kPieces + kLaneRows * j];
    uint4(*dst)[kPieces] = sm.grads[c % kStages];
    const G* src = grads + c0 + u * kPieceCols;
#pragma unroll
    for (int j = 0; j < kRows / kLaneRows; ++j) {
      cp_async16(&dst[lane / kPieces + kLaneRows * j][u], src + rows[j] * e, 16);
    }
  };

  // the first chunks' ids go out with the loads that decide whether the
  // warp has work: a segment head lies in the span unless the ids before and
  // at its end agree
  for (int c = 0; c < kStages; ++c) fetch_idx(c);
  cp_async_commit();
  cp_async_wait<0>();
  if (before == last) return;
  __syncwarp();
  for (int c = 0; c < kStages; ++c) {
    fetch_grads(c);
    fetch_idx(c + kStages);
    cp_async_commit();
  }

  // the loads above ran while the zero pass ran; the stores below may not
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // every lane sums one column of the tile (the lanes past the tile repeat
  // column 0 and store nothing), so the open segment is the warp's
  const G* col = reinterpret_cast<const G*>(&sm.grads[0][0][0]) + (lane < cols ? lane : 0);
  float* out_col = out + c0 + lane;
  const bool stores = lane < cols;
  float acc = 0.f;
  int seg_id = -1;  // -1 until the first head: positions before it are another warp's
  int prev_id = before;
  for (int k = 0;; ++k) {
    // chunk k's gradients and chunk k + kStages's ids have landed
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int* ids = sm.sorted[k % kIdxSlots];
    const G* chunk = col + (k % kStages) * kRows * kTileCols;
    const long long cs = s + static_cast<long long>(k) * kRows;
    int end = kRows;  // rows of this chunk to sum
    if (seg_id >= 0 && cs + kRows <= n && ids[kRows - 1] == seg_id) {
      // the whole chunk continues the open segment: no head, no stop
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc = __fadd_rn(acc, to_f32(chunk[r * kTileCols]));
    } else {
      unsigned heads[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int r = 32 * q + lane;
        const long long pos = cs + r;
        const int id = ids[r];
        const int prev = r == 0 ? prev_id : ids[r - 1];
        const bool valid = pos < n;
        const bool head = valid && id != prev;
        heads[q] = __ballot_sync(full, head);
        const unsigned stops = __ballot_sync(full, !valid || (head && pos >= span_end));
        if (end == kRows && stops) end = 32 * q + __ffs(stops) - 1;
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int r0 = 32 * q;
        if (r0 + 32 <= end && heads[q] == 0) {
          if (seg_id >= 0) {
            // the 32 loads go out before their adds
            float v[32];
#pragma unroll
            for (int r = 0; r < 32; ++r) v[r] = to_f32(chunk[(r0 + r) * kTileCols]);
#pragma unroll
            for (int r = 0; r < 32; ++r) acc = __fadd_rn(acc, v[r]);
          }
        } else {
          const int r1 = min(end, r0 + 32);
          for (int r = r0; r < r1; ++r) {
            if ((heads[q] >> (r - r0)) & 1u) {
              if (seg_id >= 0 && stores) out_col[static_cast<long long>(seg_id) * e] = acc;
              acc = 0.f;
              seg_id = ids[r];
            }
            if (seg_id >= 0) acc = __fadd_rn(acc, to_f32(chunk[r * kTileCols]));
          }
        }
      }
    }
    prev_id = ids[kRows - 1];
    if (end < kRows) break;
    __syncwarp();  // chunk k's slots are free again
    fetch_grads(k + kStages);
    fetch_idx(k + kIdxSlots);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy may land after the warp has left
  if (stores && seg_id >= 0) out_col[static_cast<long long>(seg_id) * e] = acc;
}

// one thread per (position, column); a thread at a segment head sums the
// segment's column in order
template <typename G>
__global__ void __launch_bounds__(kScalarThreads)
scatter_rows_scalar(const int* __restrict__ sorted, const long long* __restrict__ perm,
                    const G* __restrict__ grads, float* __restrict__ out,
                    long long n, int e) {
  const long long items = n * e;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const long long j = i / e;
    const int c = static_cast<int>(i - j * e);
    const int id = __ldg(sorted + j);
    if (j > 0 && __ldg(sorted + j - 1) == id) continue;
    float acc = 0.f;
    for (long long b = j;; b += kBatch) {
      bool in[kBatch];
      long long p[kBatch];
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) in[u] = b + u < n && __ldg(sorted + b + u) == id;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) p[u] = in[u] ? __ldg(perm + b + u) : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = in[u] ? to_f32(grads[p[u] * e + c]) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (in[u]) acc = __fadd_rn(acc, v[u]);
      }
      if (!in[kBatch - 1]) break;
    }
    out[static_cast<long long>(id) * e + c] = acc;
  }
}

long long sm_count() {
  static const long long count = [] {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return static_cast<long long>(sms > 0 ? sms : 1);
  }();
  return count;
}

unsigned blocks_for(long long items, int threads) {
  const long long b = (items + threads - 1) / threads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename G>
void launch_segments(const int* sorted, const long long* perm, const G* grads, float* out,
                     long long n, int e, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kSpan - 1) / kSpan),
                  static_cast<unsigned>((e + kTileCols - 1) / kTileCols));
  // programmatic dependent launch: the walk may start while the zero pass
  // before it on the stream runs, and waits for it before its first store
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, scatter_rows_segments<G>, sorted, perm, grads, out, n, e);
}

// vec: rows of whole 16-byte pieces, the inputs 16-byte aligned
template <typename G>
void launch(const int* sorted, const long long* perm, const G* grads, float* out,
            long long n, long long vocab, int e, bool vec, cudaStream_t s) {
  const long long count = vocab * e;
  const bool zero_vec = count % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long zero_blocks = (zero_vec ? count / 4 : count) / kZeroThreads + 1;
  scatter_rows_zero<<<static_cast<unsigned>(std::min(zero_blocks, kZeroBlocksPerSm * sm_count())),
                      kZeroThreads, 0, s>>>(out, count, zero_vec);
  if (n <= 0) return;
  if (vec) {
    launch_segments(sorted, perm, grads, out, n, e, s);
  } else {
    scatter_rows_scalar<G><<<blocks_for(n * e, kScalarThreads), kScalarThreads, 0, s>>>(
        sorted, perm, grads, out, n, e);
  }
}

}  // namespace

// sorted_ids (n,) int32 ascending, perm (n,) int64 with
// sorted_ids[j] == ids[perm[j]] and each id's positions in ascending perm
// (a stable sort), grads (n, e) f32 or bf16, out (vocab, e) f32; all
// contiguous. Every element of out is written.
extern "C" int map_tpu_scatter_add(const void* sorted_ids, const void* perm,
                                   const void* grads, void* out, long long n,
                                   long long vocab, int e, int grads_bf16,
                                   void* stream) {
  if (vocab <= 0 || e <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = e % (grads_bf16 ? 8 : 4) == 0 &&
                   reinterpret_cast<uintptr_t>(grads) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sorted_ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(perm) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sorted = static_cast<const int*>(sorted_ids);
  const long long* pm = static_cast<const long long*>(perm);
  float* o = static_cast<float*>(out);
  if (grads_bf16) {
    launch(sorted, pm, static_cast<const __nv_bfloat16*>(grads), o, n, vocab, e, vec, s);
  } else {
    launch(sorted, pm, static_cast<const float*>(grads), o, n, vocab, e, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
