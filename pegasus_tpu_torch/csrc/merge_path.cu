// Merge-path merge of two sorted multi-column runs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pegasus_tpu/ops/pallas_merge.py
// merge_two_sorted_pallas (pl.pallas_call at :310): two runs, each sorted
// ascending by their first nk columns (lexicographic), are merged into
// exactly la+lb ascending rows, every column carried. Compaction merges
// its runs pairwise through this kernel (ops/compact.py _pipeline_body).
//
// Layout: each operand is one contiguous int64 buffer [n_cols, L] (column
// c of A at a + c*la). The key columns hold u32 values widened to int64,
// so a signed int64 compare is the unsigned u32 order of the reference.
// Ties take A first; in compaction they occur only among identical pad
// rows of one run, where any order writes the same bytes.
//
// Design, and what bounds it: the work is a single pass over memory
// (each input row read once, each output row written once; a few integer
// compares per row), so it is bound by device-memory bytes, not by
// operations. The TPU kernel's 1024-element tile alignment, MXU lane
// permutes and boolean-algebra selects existed for Mosaic and are not
// carried over. Here:
//   1. each thread owns kItems consecutive outputs starting at diagonal
//      d = (block * kThreads + thread) * kItems and binary-searches its
//      merge-path split (ai + bi = d) over the nk key columns;
//   2. it merges its kItems outputs sequentially over the key columns
//      and records each output's source row (A row i, or B row j as ~j)
//      in shared memory;
//   3. the block then writes every column of its kTile outputs with
//      consecutive threads on consecutive addresses (coalesced stores),
//      gathering from A and B, whose reads are near-sequential.
// Shared-memory input windows (cp.async / TMA) and a CTA-wide merge are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// strict x[:, i] < y[:, j] over the first nk columns
__device__ __forceinline__ bool row_less(const int64_t* __restrict__ x,
                                         int64_t lx, int64_t i,
                                         const int64_t* __restrict__ y,
                                         int64_t ly, int64_t j, int nk) {
  for (int c = 0; c < nk; ++c) {
    const int64_t u = x[c * lx + i];
    const int64_t v = y[c * ly + j];
    if (u != v) return u < v;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ a, int64_t la,
                  const int64_t* __restrict__ b, int64_t lb,
                  int64_t* __restrict__ out, int n_cols, int nk) {
  __shared__ int64_t src[kTile];  // >= 0: row of A; < 0: ~row of B
  const int64_t total = la + lb;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t d0 = base + static_cast<int64_t>(threadIdx.x) * kItems;
  if (d0 < total) {
    // split: the number of A rows among the first d0 outputs
    int64_t lo = d0 > lb ? d0 - lb : 0;
    int64_t hi = d0 < la ? d0 : la;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      // A[mid] precedes B[d0-1-mid] unless B's row is strictly smaller
      if (!row_less(b, lb, d0 - 1 - mid, a, la, mid, nk)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int64_t i = lo;
    int64_t j = d0 - lo;
    const int64_t end = d0 + kItems < total ? d0 + kItems : total;
    int64_t* s = src + threadIdx.x * kItems;
    for (int64_t k = d0; k < end; ++k) {
      const bool take_a =
          j >= lb || (i < la && !row_less(b, lb, j, a, la, i, nk));
      if (take_a) {
        *s++ = i++;
      } else {
        *s++ = ~j;
        ++j;
      }
    }
  }
  __syncthreads();
  const int64_t n_here = total - base < kTile ? total - base : kTile;
  for (int c = 0; c < n_cols; ++c) {
    const int64_t* __restrict__ ac = a + c * la;
    const int64_t* __restrict__ bc = b + c * lb;
    int64_t* __restrict__ oc = out + c * total + base;
    for (int t = threadIdx.x; t < n_here; t += kThreads) {
      const int64_t r = src[t];
      oc[t] = r >= 0 ? ac[r] : bc[~r];
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t, PyTorch's current stream); does
// not synchronise and allocates nothing. Returns the cudaError_t of the
// launch (0 = success). The caller validates shapes and types.
extern "C" int merge_two_sorted_i64(const void* a, int64_t la, const void* b,
                                    int64_t lb, void* out, int n_cols, int nk,
                                    void* stream) {
  const int64_t total = la + lb;
  if (total == 0) return 0;
  const int64_t blocks = (total + kTile - 1) / kTile;
  merge_path_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), la, static_cast<const int64_t*>(b), lb,
      static_cast<int64_t*>(out), n_cols, nk);
  return static_cast<int>(cudaGetLastError());
}
