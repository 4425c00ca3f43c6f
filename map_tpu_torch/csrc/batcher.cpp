// Host-side batch assembly: the input pipeline's row gathers and the alias
// table build, in C++ on the host. Counterpart: map_tpu/native/batcher.cpp.
//
// The Batcher gathers each batch's rows out of the train matrix (in RAM or
// a memmap of the >RAM mode) on the prefetch thread; called through ctypes,
// which releases the GIL, these gathers overlap the training loop's Python
// work, and a few OpenMP threads split a large gather. Plain C interface,
// built by map_tpu_torch/kernels/build.py:host_library() with the host
// compiler.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

namespace {

// One thread per 8192 rows, at most 4 and the host's processors: a batch of
// 4096 rows is one thread's (waking others would cost more than they save),
// a group of 8 such batches takes 4. OpenMP keeps its threads between calls.
// The processor count is read once: omp_get_num_procs() asks the kernel for
// the thread's affinity on every call, a system call that costs more than a
// batch's gather on a host whose system calls are slow (a virtualised one).
int threads_for(int64_t rows) {
  if (rows < 2 * 8192) return 1;
  static const int64_t procs = std::max(1, omp_get_num_procs());
  return static_cast<int>(std::min<int64_t>({4, procs, rows / 8192}));
}

// out[i, :] = x[idx[i], :] for i in [lo, hi), rows of `cols` elements;
// the row 8 ahead is prefetched (the rows are scattered over the matrix).
template <typename T>
void copy_rows(const T* __restrict x, int64_t cols, const int64_t* __restrict idx,
               int64_t lo, int64_t hi, T* __restrict out) {
  const size_t bytes = static_cast<size_t>(cols) * sizeof(T);
  for (int64_t i = lo; i < hi; ++i) {
    if (i + 8 < hi) __builtin_prefetch(x + idx[i + 8] * cols);
    std::memcpy(out + i * cols, x + idx[i] * cols, bytes);
  }
}

// The gather of n rows: on the calling thread below 8192 rows (no OpenMP
// call at all), else on threads_for(n) OpenMP threads, a contiguous range
// of rows each.
template <typename T>
void gather_rows(const T* x, int64_t cols, const int64_t* idx, int64_t n, T* out) {
  const int nthreads = threads_for(n);
  if (nthreads == 1) {
    copy_rows(x, cols, idx, 0, n, out);
    return;
  }
#pragma omp parallel num_threads(nthreads)
  {
    const int64_t t = omp_get_thread_num(), k = omp_get_num_threads();
    const int64_t chunk = (n + k - 1) / k;
    copy_rows(x, cols, idx, std::min(n, t * chunk), std::min(n, (t + 1) * chunk), out);
  }
}

}  // namespace

extern "C" {

// out[i, :] = x[idx[i], :] over a C-contiguous int32 (rows, cols) matrix.
void map_tpu_torch_gather_rows_i32(const int32_t* x, int64_t cols, const int64_t* idx,
                                   int64_t n, int32_t* out) {
  gather_rows<int32_t>(x, cols, idx, n, out);
}

// out[i] = x[idx[i]] over a float32 vector.
void map_tpu_torch_gather_f32(const float* x, const int64_t* idx, int64_t n, float* out) {
  gather_rows<float>(x, 1, idx, n, out);
}

// Walker's alias table over k probabilities summing to 1, in the order of
// map_tpu/objectives/alias.py:build_alias_table (indices below 1 and the
// rest each kept in ascending order, both taken from the back; the leftovers
// set to 1), in double precision, then float32 probabilities.
void map_tpu_torch_build_alias(const double* probs, int64_t k, float* out_prob,
                               int32_t* out_alias) {
  std::vector<double> scaled(k);
  std::vector<int64_t> smaller, larger;
  smaller.reserve(k);
  larger.reserve(k);
  for (int64_t i = 0; i < k; ++i) {
    scaled[i] = probs[i] * static_cast<double>(k);
    out_alias[i] = 0;
    (scaled[i] < 1.0 ? smaller : larger).push_back(i);
  }
  while (!smaller.empty() && !larger.empty()) {
    const int64_t small = smaller.back();
    smaller.pop_back();
    const int64_t large = larger.back();
    larger.pop_back();
    out_alias[small] = static_cast<int32_t>(large);
    scaled[large] = (scaled[large] - 1.0) + scaled[small];
    (scaled[large] < 1.0 ? smaller : larger).push_back(large);
  }
  for (int64_t i : smaller) scaled[i] = 1.0;
  for (int64_t i : larger) scaled[i] = 1.0;
  for (int64_t i = 0; i < k; ++i) out_prob[i] = static_cast<float>(scaled[i]);
}

}  // extern "C"
