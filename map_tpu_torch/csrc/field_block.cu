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
// K6b's order contract: each tile row is summed in f32, from 0.0, with
// __fadd_rn, in the order of (pair, b), a tile's pairs in pos order. For a
// row of one field that is the order of b, the order in which K3
// (scatter_add.cu) sums the row's segment of the stably sorted ids, so the
// hybrid backward's bwd_pallas route gives the flat route's bits, and every
// run gives the same bits. No sum is split or reordered.
//
// K6b bound: device-memory bytes, the g rows of the small fields read once
// (B * Fs * W * 2 in bf16), the ids read once, the tiles written once: about
// 5 MB, 1.6 microseconds at 3.35 TB/s at the training shape (B = 4096, 21
// small fields, 65 tiles). Beside it stands the order floor: the longest
// row's chain of dependent adds (about 1,000 for a 4-id field at B = 4096),
// 4 cycles each.
//
// K6b design. The work is uneven: at the training shape tile 0 holds four
// tiny fields (about 16,800 hits, 20,480 ids to read), the median tile about
// 270 hits. So a tile's rows are spread over 4 to 16 blocks, as many as its
// expected hits ask (map_tpu_torch/ops/field_gather.py:tile_slices); block q
// of n takes rows q, q + n, ..., so a tiny field's consecutive hot rows land
// on different blocks. The work list, a record a block, puts the heavy
// tiles' blocks first. A block:
// 1. reads its tile's ids in (pair, b) order, 2,048 a chunk (1,024 with f32
//    g), with cp.async into a ring of 3 chunks, so the next chunks' ids are in
//    flight; one barrier a chunk;
// 2. keeps the ids on its rows by a stable compaction (a warp scan of each
//    thread's count, a scan of the warps' sums; no atomics), and at once
//    copies each hit's 16 columns of g into shared memory, the 16-byte
//    pieces of a row from neighbouring lanes, so the g loads overlap the
//    id scan;
// 3. when the batch of staged hits is full, or the ids end, sorts the batch
//    by row with a stable counting sort (each warp counts a contiguous range
//    by __match_any_sync, an exclusive scan over (row, warp), each warp
//    places its hits by in-warp rank), while the copies land;
// 4. walks each row over its hits in order, 16 threads a row, one column
//    each, from shared memory, the next 16 hits' values loading while the
//    current ones add and their offsets loading 8 at a time: only the adds
//    are on the dependent chain. A row's sum carries over in a register from
//    one batch to the next, so a full batch changes nothing of the order.
// W above 16 takes a column grid. The tile is written to a compact (U, 512,
// W) stack (rows no id hits are 0), or added onto a dense (R, W) gradient
// (the hybrid backward adds after K3, which writes every row; rows no id
// hits are not touched); the last tile may run past R, and rows past R are
// not written.
//
// K6a design: a block takes a range of b (ops/field_gather.py:gather_plan),
// reads phys[:, b0:b0 + T] along b, coalesced, into shared memory, with an
// id outside its field's tiles made -1 there (the windows load beside the
// ids, in the same round trip); then it writes the range's output rows, one
// contiguous span, in order, each thread loading a batch of 8 row pieces (16
// bytes each; -1 gives zeros) before it stores them: a transpose through
// shared memory, the row loads batched as in K4 (embedding_gather.cu).
//
// Both take W a multiple of 4 and 16-byte aligned tensors (the wrapper
// checks). Ids must be -1 or in [0, R); the kernels do not check it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;
constexpr int kThreads = 256;                        // K6a
constexpr int kGatherBatch = 8;                      // K6a's loads a thread in flight

// K6b
constexpr int kMinSlices = 4;                        // blocks a tile at least (16 at most)
constexpr int kMaxRows = kTile / kMinSlices;         // 128 rows a block at most
constexpr int kCols = 16;                            // columns a block
constexpr int kScatterThreads = 512;                 // a thread per (row % 32, column)
constexpr int kScatterWarps = kScatterThreads / 32;  // 16
constexpr int kRowGroups = kScatterThreads / kCols;  // 32 rows walked at once
constexpr int kMaxRowsPerThread = kMaxRows / kRowGroups;  // 4
constexpr int kMaxPairs = kTile;  // a tile's pairs: windows do not overlap

__device__ __forceinline__ float4 load4(const float* g) {
  return __ldg(reinterpret_cast<const float4*>(g));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// copies 4, 8 or 16 bytes from global to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Per G: ids a thread reads a chunk, and the batch of hits staged at once
// (as many as a chunk's ids, so one chunk's hits always fit an empty batch):
// 64 KB of staged g either way, and kStages chunks of ids in flight.
template <typename G>
struct ScatterShape {
  static constexpr int kPer = sizeof(G) == 2 ? 4 : 2;
  static constexpr int kCap = kScatterThreads * kPer;   // ids a chunk, hits a batch
  static constexpr int kStages = 3;                     // chunks of ids in flight
  static constexpr int kSlack = 16;                     // sorted's entries past kCap
  static constexpr int kCounts = kMaxRows * kScatterWarps;  // (row, warp) counts
  static constexpr size_t kStagedBytes = static_cast<size_t>(kCap) * kCols * sizeof(G);
  static constexpr size_t kSmem = kStagedBytes + kStages * kCap * 4  // staged g, ids
                                  + kCap * (4 + 2 + 1) + kSlack * 2  // g offset, sorted, row
                                  + (kMaxPairs + kCounts + kMaxRows + 1 + 2 * 32 + 32) * 4;
};

template <typename G>
struct ScatterSmem {
  using S = ScatterShape<G>;
  G* staged;        // (kCap, kCols): each hit's columns, in batch order
  int* ids;         // (kStages, kCap): the ring of id chunks
  int* goff;        // (kCap,) each hit's offset in g
  int* tile_pos;    // (kMaxPairs,) the field position of each of the tile's pairs
  int* cnt;         // (rows, kScatterWarps) counts, then cursors
  int* row_start;   // (rows + 1,)
  int* wsum;        // (2, 32) warp sums of a chunk, by its parity
  int* wtot;        // (32,) warp totals of the scan
  unsigned short* sorted;  // (kCap + kSlack,) the hits' byte offsets in staged, by row, stable
  unsigned char* hrow;  // (kCap,) the hit's row in the block

  __device__ explicit ScatterSmem(unsigned char* base) {
    staged = reinterpret_cast<G*>(base);
    base += S::kStagedBytes;
    ids = reinterpret_cast<int*>(base);
    base += S::kStages * S::kCap * 4;
    goff = reinterpret_cast<int*>(base);
    base += S::kCap * 4;
    sorted = reinterpret_cast<unsigned short*>(base);  // 16-byte aligned
    base += (S::kCap + S::kSlack) * 2;
    tile_pos = reinterpret_cast<int*>(base);
    base += kMaxPairs * 4;
    cnt = reinterpret_cast<int*>(base);
    base += S::kCounts * 4;
    row_start = reinterpret_cast<int*>(base);
    base += (kMaxRows + 1) * 4;
    wsum = reinterpret_cast<int*>(base);
    base += 2 * 32 * 4;
    wtot = reinterpret_cast<int*>(base);
    base += 32 * 4;
    hrow = base;
  }
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// o[u] = sorted[at + u] for u < K, at a multiple of 8: K / 8 16-byte loads
template <int K>
__device__ __forceinline__ void load_offsets(const unsigned short* sorted, int at,
                                             unsigned (&o)[K]) {
  const uint4* p = reinterpret_cast<const uint4*>(sorted + at);
#pragma unroll
  for (int v = 0; v < K / 8; ++v) {
    const uint4 e = p[v];
    const unsigned w[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[8 * v + 2 * k] = w[k] & 0xffffu;
      o[8 * v + 2 * k + 1] = w[k] >> 16;
    }
  }
}

// Sorts the batch's n hits by row, stably, then walks each of the block's
// rows (32 to 128) over its hits in order: the thread of (row % 32, column)
// adds onto acc[row / 32], one row after another.
template <typename G>
__device__ void sort_and_walk(const ScatterSmem<G>& sm, int n, int rows,
                              float (&acc)[kMaxRowsPerThread],
                              unsigned& hit) {
  using S = ScatterShape<G>;
  constexpr int kSpan = S::kCap / kScatterWarps;  // batch entries a warp counts
  constexpr int kAhead = S::kSlack;               // hits a batch of the walk
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int each = rows / kRowGroups;  // the (row, warp) counts a thread holds
#pragma unroll
  for (int e = 0; e < kMaxRowsPerThread; ++e) {
    if (e < each) sm.cnt[t * each + e] = 0;
  }
  __syncthreads();  // the batch's rows are in place; its copies may still be in flight

  // each warp counts the hits of its contiguous range by row
  for (int s = 0; s < kSpan; s += 32) {
    const int j = warp * kSpan + s + lane;
    const int row = j < n ? sm.hrow[j] : -1;
    const unsigned peers = __match_any_sync(full, row);
    if (row >= 0 && lane == __ffs(peers) - 1) sm.cnt[row * kScatterWarps + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan over (row, warp) in that order
  int v[kMaxRowsPerThread], local = 0;
#pragma unroll
  for (int e = 0; e < kMaxRowsPerThread; ++e) {
    v[e] = e < each ? sm.cnt[t * each + e] : 0;
    local += v[e];
  }
  const int incl = warp_inclusive_scan(local, lane);
  if (lane == 31) sm.wtot[warp] = incl;
  __syncthreads();
  int run = incl - local;
  for (int k = 0; k < warp; ++k) run += sm.wtot[k];
#pragma unroll
  for (int e = 0; e < kMaxRowsPerThread; ++e) {
    if (e < each) {
      const int x = t * each + e;
      sm.cnt[x] = run;  // the cursor of (row, warp)
      if (x % kScatterWarps == 0) sm.row_start[x / kScatterWarps] = run;
      run += v[e];
    }
  }
  if (t == 0) sm.row_start[rows] = n;
  __syncthreads();

  // each warp places its hits in order: cursor + rank among the lanes before
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < kSpan; s += 32) {
    const int j = warp * kSpan + s + lane;
    const int row = j < n ? sm.hrow[j] : -1;
    const unsigned peers = __match_any_sync(full, row);
    int* cursor = &sm.cnt[(row < 0 ? 0 : row) * kScatterWarps + warp];
    if (row >= 0) {
      sm.sorted[*cursor + __popc(peers & below)] =
          static_cast<unsigned short>(j * kCols * sizeof(G));
    }
    __syncwarp();
    if (row >= 0 && lane == __ffs(peers) - 1) *cursor += __popc(peers);
    __syncwarp();
  }
  cp_async_wait_all();
  __syncthreads();  // the batch's order and its g rows are in place

  // the walk: the loads of kAhead hits, then their adds, in order
  const unsigned char* col = reinterpret_cast<const unsigned char*>(sm.staged + t % kCols);
  auto value = [&](unsigned off) { return to_f32(*reinterpret_cast<const G*>(col + off)); };
#pragma unroll
  for (int m = 0; m < kMaxRowsPerThread; ++m) {
    const int row = m * kRowGroups + t / kCols;
    if (row >= rows) break;
    const int end = sm.row_start[row + 1];
    int i = sm.row_start[row];
    if (i < end) hit |= 1u << m;
    float a = acc[m];
    // single hits up to a multiple of 8, then batches of kAhead whose
    // offsets load 8 at a time
    for (; i < end && (i & 7); ++i) a = __fadd_rn(a, value(sm.sorted[i]));
    if (i + kAhead <= end) {
      // software-pipelined: batch k's adds run while batch k + 1's values and
      // batch k + 2's offsets load; the offsets are read a batch ahead even
      // past the row's end (the array has kAhead entries of slack), and only
      // those before it are used
      unsigned idx[kAhead];
      float x[kAhead];
      load_offsets(sm.sorted, i, idx);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) x[u] = value(idx[u]);
      load_offsets(sm.sorted, i + kAhead, idx);
      for (i += kAhead; i + kAhead <= end; i += kAhead) {
        float y[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) y[u] = value(idx[u]);
        load_offsets(sm.sorted, i + kAhead, idx);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) a = __fadd_rn(a, x[u]);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) x[u] = y[u];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) a = __fadd_rn(a, x[u]);
    }
    for (; i < end; ++i) a = __fadd_rn(a, value(sm.sorted[i]));
    acc[m] = a;
  }
  __syncthreads();  // the batch's buffers are free again
}

// grid (blocks, ceil(w / kCols)); block kScatterThreads. Block x takes the
// work record x: (slot, the tile's first row, first pair, pairs | q << 12 |
// log2 slices << 20): the tile's rows q, q + slices, ..., and the columns
// [kCols y, kCols y + kCols). vec: g's rows are whole 16-byte pieces (always
// in f32; w % 8 == 0 in bf16).
template <typename G>
__global__ void __launch_bounds__(kScatterThreads, 2)
field_block_scatter_kernel(const G* __restrict__ g, const int* __restrict__ phys,
                           const int4* __restrict__ work, const int* __restrict__ pair_pos,
                           float* __restrict__ out, int b, int fs, int w, long long r,
                           int add, int vec) {
  using S = ScatterShape<G>;
  // 16-byte pieces of a row's kCols columns, or 8-byte ones
  constexpr int kVecPieces = kCols * sizeof(G) / 16;
  constexpr int kPieces = kCols * sizeof(G) / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ScatterSmem<G> sm(smem_raw);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int4 item = work[blockIdx.x];
  const int slot = item.x, row0 = item.y, pair0 = item.z;
  const int pairs = item.w & 0xfff;
  const int q = (item.w >> 12) & 0xff;
  const int slog = item.w >> 20;
  const int rows = kTile >> slog;  // the block's rows
  const int first = row0 + q;  // the tile's rows q, q + 2**slog, ...
  const unsigned span = kTile - q;
  const int mask = (1 << slog) - 1;
  const int total = pairs * b;  // the tile's positions
  const int chunks = (total + S::kCap - 1) / S::kCap;
  const int c0 = blockIdx.y * kCols;
  const int ld = fs * w;  // g's row stride (g has fewer than 2**31 elements)
  // a thread's kPer positions of a chunk lie in one pair when b % kPer == 0
  const bool ids_vec = b % S::kPer == 0;
  // p / b for 0 <= p < 2**31: the high word of p * floor((2**32 - 1) / b) is
  // p / b or one less
  const unsigned magic = 0xffffffffu / static_cast<unsigned>(b);
  auto div_b = [&](int p) {
    const int k = static_cast<int>(__umulhi(static_cast<unsigned>(p), magic));
    return static_cast<unsigned>(k + 1) * b <= static_cast<unsigned>(p) ? k + 1 : k;
  };

  // Position p = k * b + bb is pair k's id of row bb; a thread reads the
  // kPer positions from p = chunk * kCap + t * kPer on. The chunk's ids go
  // into its ring slot, as one commit group with whatever copies the thread
  // issued since the last one; every address is read before the first copy
  // goes out (a copy's memory clobber keeps a later read behind it).
  auto fetch_ids = [&](int chunk) {
    const int p = chunk * S::kCap + t * S::kPer;
    if (chunk < chunks && p < total) {
      int k = div_b(p);
      int bb = p - k * b;
      int* dst = sm.ids + (chunk % S::kStages) * S::kCap + t * S::kPer;
      if (ids_vec) {
        cp_async<S::kPer * 4>(dst, phys + static_cast<long long>(sm.tile_pos[k]) * b + bb);
      } else {
        const int* src[S::kPer];
#pragma unroll
        for (int i = 0; i < S::kPer; ++i) {
          src[i] = p + i < total ? phys + static_cast<long long>(sm.tile_pos[k]) * b + bb
                                 : nullptr;
          if (++bb == b) bb = 0, ++k;
        }
#pragma unroll
        for (int i = 0; i < S::kPer; ++i) {
          if (src[i] != nullptr) cp_async<4>(dst + i, src[i]);
        }
      }
    }
    cp_async_commit();
  };

  float acc[kMaxRowsPerThread];
  unsigned hit = 0;  // bit m: row group m has a hit
#pragma unroll
  for (int m = 0; m < kMaxRowsPerThread; ++m) acc[m] = 0.f;
  int n = 0;  // hits in the batch
  for (int k = t; k < pairs; k += kScatterThreads) sm.tile_pos[k] = __ldg(pair_pos + pair0 + k);
  __syncthreads();
  // one barrier a chunk: after it chunk c's warp sums and chunk c + 1's ids
  // are in place
  for (int c = 0; c < S::kStages - 1; ++c) fetch_ids(c);
  cp_async_wait<S::kStages - 2>();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    fetch_ids(c + S::kStages - 1);
    const int p0 = c * S::kCap + t * S::kPer;
    const int* ids = sm.ids + (c % S::kStages) * S::kCap + t * S::kPer;
    int id[S::kPer];
    if constexpr (S::kPer == 4) {
      const int4 v = *reinterpret_cast<const int4*>(ids);
      id[0] = v.x, id[1] = v.y, id[2] = v.z, id[3] = v.w;
    } else {
      const int2 v = *reinterpret_cast<const int2*>(ids);
      id[0] = v.x, id[1] = v.y;
    }
    // e = id - row0 - q: the id is the block's when 0 <= e < kTile - q and
    // e is a multiple of the slices (-1, and ids below the tile, give e < 0)
    int mine[S::kPer];  // the block's row of each id, or -1
    int count = 0;
    const int left = total - p0;
#pragma unroll
    for (int i = 0; i < S::kPer; ++i) {
      const int e = id[i] - first;
      const bool in = static_cast<unsigned>(e) < span && (e & mask) == 0 && i < left;
      mine[i] = in ? e >> slog : -1;
      count += in;
    }

    // stable compaction: the chunk's hits keep the order of p
    const int incl = warp_inclusive_scan(count, lane);
    if (lane == 31) sm.wsum[(c & 1) * 32 + warp] = incl;
    cp_async_wait<S::kStages - 2>();  // chunk c + 1's ids have landed
    __syncthreads();
    // the warps' sums, scanned across lanes 0..15
    int sums = lane < kScatterWarps ? sm.wsum[(c & 1) * 32 + lane] : 0;
    sums = warp_inclusive_scan(sums, lane);
    const int chunk_hits = __shfl_sync(0xffffffffu, sums, kScatterWarps - 1);
    const int before = __shfl_sync(0xffffffffu, sums, warp > 0 ? warp - 1 : 0) * (warp > 0);
    if (n + chunk_hits > S::kCap) {
      sort_and_walk(sm, n, rows, acc, hit);
      n = 0;
    }
    // each hit's row and g offset at its batch index; then the warp copies
    // its hits' g rows, the pieces of a row from neighbouring lanes
    const int warp_first = n + before;
    int j = warp_first + incl - count;
    if (count > 0) {
      // g's offset of position p0 + i: (bb + i) ld + pos w + c0 while bb + i
      // stays in pair k (always when b % kPer == 0)
      const int k = div_b(p0);
      const int bb = p0 - k * b;
      const int base = bb * ld + sm.tile_pos[k] * w + c0;
#pragma unroll
      for (int i = 0; i < S::kPer; ++i) {
        if (mine[i] >= 0) {
          int off = base + i * ld;
          if (bb + i >= b) {
            const int ki = div_b(p0 + i);
            off = (p0 + i - ki * b) * ld + sm.tile_pos[ki] * w + c0;
          }
          sm.goff[j] = off;
          sm.hrow[j] = static_cast<unsigned char>(mine[i]);
          ++j;
        }
      }
    }
    __syncwarp();
    const int warp_hits = __shfl_sync(0xffffffffu, incl, 31);
    if (vec) {
      for (int x = lane; x < warp_hits * kVecPieces; x += 32) {
        const int jj = warp_first + x / kVecPieces;
        const int u = (x % kVecPieces) * (16 / sizeof(G));
        if (c0 + u < w) cp_async<16>(sm.staged + jj * kCols + u, g + sm.goff[jj] + u);
      }
    } else {
      for (int x = lane; x < warp_hits * kPieces; x += 32) {
        const int jj = warp_first + x / kPieces;
        const int u = (x % kPieces) * (8 / sizeof(G));
        if (c0 + u < w) cp_async<8>(sm.staged + jj * kCols + u, g + sm.goff[jj] + u);
      }
    }
    n += chunk_hits;
  }
  if (n > 0) sort_and_walk(sm, n, rows, acc, hit);
  cp_async_wait_all();  // no copy may land after the block has left

  const int col = c0 + t % kCols;
  if (col >= w) return;
#pragma unroll
  for (int m = 0; m < kMaxRowsPerThread; ++m) {
    if (m * kRowGroups + t / kCols >= rows) break;
    const int row = ((m * kRowGroups + t / kCols) << slog) + q;  // the tile's row
    if (add) {
      const long long grow = static_cast<long long>(row0) + row;
      if ((hit >> m & 1u) && grow < r) out[grow * w + col] = __fadd_rn(out[grow * w + col], acc[m]);
    } else {
      out[(static_cast<long long>(slot) * kTile + row) * w + col] = acc[m];
    }
  }
}

template <typename G>
int launch_scatter(const G* g, const int* phys, const int4* work, const int* pair_pos,
                   float* out, int b, int fs, int w, long long r, int blocks, int add,
                   cudaStream_t s) {
  constexpr size_t smem = ScatterShape<G>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      field_block_scatter_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((w + kCols - 1) / kCols));
  const int vec = (w * sizeof(G)) % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  field_block_scatter_kernel<G><<<grid, kScatterThreads, smem, s>>>(
      g, phys, work, pair_pos, out, b, fs, w, r, add, vec);
  return static_cast<int>(cudaGetLastError());
}

// K6a: block x takes the b_per_block rows of b from b0 = x * b_per_block;
// their outputs, rows b0 .. of (b, fs * w), are one contiguous span.
__global__ void __launch_bounds__(kThreads)
field_block_gather_kernel(const float* __restrict__ table, const int* __restrict__ phys,
                          const int* __restrict__ win_lo, const int* __restrict__ win_hi,
                          float* __restrict__ out, int b, int fs, int w, int b_per_block) {
  extern __shared__ int sid[];  // (b_per_block, fs): the id of (b0 + j, pos), -1 = zeros
  const int b0 = blockIdx.x * b_per_block;
  const int nb = min(b_per_block, b - b0);
  // phys[:, b0:b0 + nb], read along b, each id beside its field's window
  // (loads of one round trip; the windows stay in L1)
  for (int i = threadIdx.x; i < fs * b_per_block; i += kThreads) {
    const int pos = i / b_per_block, j = i - pos * b_per_block;
    if (j < nb) {
      const int id = __ldg(phys + static_cast<long long>(pos) * b + b0 + j);
      const int lo = __ldg(win_lo + pos), hi = __ldg(win_hi + pos);
      sid[j * fs + pos] = id >= 0 && id >= lo && id < hi ? id : -1;
    }
  }
  __syncthreads();

  // the span's float4 pieces in order: piece k is (j, pos, q), k = (j * fs +
  // pos) * per_pos + q. A thread takes pieces t, t + kThreads, ...: its
  // (j, pos, q) steps by (dj, dpos, dq) with a carry, and it loads a batch of
  // kGatherBatch pieces before it stores them.
  const int per_pos = w >> 2;
  const int per_b = fs * per_pos;
  const int pieces = nb * per_b;
  const int dj = kThreads / per_b, dpos = kThreads % per_b / per_pos,
            dq = kThreads % per_pos;
  int j = threadIdx.x / per_b;
  int pos = threadIdx.x % per_b / per_pos;
  int q = threadIdx.x % per_pos;
  float4* o = reinterpret_cast<float4*>(out) + static_cast<long long>(b0) * per_b;
  for (int k0 = threadIdx.x; k0 < pieces; k0 += kThreads * kGatherBatch) {
    float4 v[kGatherBatch];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int id = k0 + u * kThreads < pieces ? sid[j * fs + pos] : -1;
      v[u] = id >= 0 ? load4(table + static_cast<long long>(id) * w + 4 * q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      q += dq;
      if (q >= per_pos) {
        q -= per_pos;
        ++pos;
      }
      pos += dpos;
      if (pos >= fs) {
        pos -= fs;
        ++j;
      }
      j += dj;
    }
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      if (k0 + u * kThreads < pieces) o[k0 + u * kThreads] = v[u];
    }
  }
}

}  // namespace

// g (b, fs * w) f32 or bf16; phys (fs, b) int32, -1 = skip; work (blocks,
// 4) int32, a record a block, the heavy tiles' first: (slot, the tile's first
// row, first pair, pairs | q << 12 | log2 slices << 20) with 4 to 16 slices,
// the tile's pairs' field positions at pair_pos[first pair:first pair +
// pairs] in ascending order (at most 512), and every (tile, row) in one
// block. add = 0: out is the (u, 512, w) stack, every element written; add =
// 1: out is the dense (r, w) gradient, each tile added onto its rows below r
// that an id hits. All contiguous, w % 4 == 0, 16-byte aligned, g below
// 2**31 elements, and a tile's pairs times b below 2**31 - 2**16.
extern "C" int map_tpu_field_block_scatter(const void* g, const void* phys, const void* work,
                                           const void* pair_pos, void* out, int b, int fs,
                                           int w, long long r, int blocks, int g_bf16,
                                           int add, void* stream) {
  if (blocks <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ph = static_cast<const int*>(phys);
  const int4* wk = static_cast<const int4*>(work);
  const int* pp = static_cast<const int*>(pair_pos);
  float* o = static_cast<float*>(out);
  if (g_bf16) {
    return launch_scatter(static_cast<const __nv_bfloat16*>(g), ph, wk, pp, o, b, fs, w, r,
                          blocks, add, s);
  }
  return launch_scatter(static_cast<const float*>(g), ph, wk, pp, o, b, fs, w, r, blocks, add,
                        s);
}

// table (r, w) f32; phys (fs, b) int32, -1 = skip; win_lo / win_hi (fs,)
// int32, the rows [lo, hi) of field pos's tiles; out (b, fs * w) f32, every
// element written. All contiguous and 16-byte aligned, w % 4 == 0; the plan
// (ops/field_gather.py:gather_plan): blocks of b_per_block rows of b, whose
// ids, b_per_block * fs ints, fit 48 KB of shared memory, and b_per_block *
// fs * w below 2**31. A plan that does not fit is refused with
// cudaErrorInvalidValue.
extern "C" int map_tpu_field_block_gather(const void* table, const void* phys,
                                          const void* win_lo, const void* win_hi, void* out,
                                          int b, int fs, int w, int b_per_block,
                                          void* stream) {
  if (b <= 0 || fs <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const long long smem = static_cast<long long>(b_per_block) * fs * 4;
  if (w % 4 != 0 || b_per_block < 1 || smem > 48 * 1024 ||
      static_cast<long long>(b_per_block) * fs * w >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((b + b_per_block - 1) / b_per_block);
  field_block_gather_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(phys),
      static_cast<const int*>(win_lo), static_cast<const int*>(win_hi),
      static_cast<float*>(out), b, fs, w, b_per_block);
  return static_cast<int>(cudaGetLastError());
}
