// Merge-path merge of two sorted multi-column runs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pegasus_tpu/ops/pallas_merge.py
// merge_two_sorted_pallas (pl.pallas_call at :310): two runs, each sorted
// ascending by their first nk columns (lexicographic), are merged into
// exactly la+lb ascending rows, every column carried. Compaction merges
// its runs pairwise through this kernel (ops/compact.py _pipeline_body).
//
// Layout: each operand is one contiguous int64 buffer [batch, n_cols, L]:
// `batch` independent merges (a batch row b's column c of A at
// a + (b*n_cols + c)*la), row b of A merged with row b of B into row b of
// the output [batch, n_cols, la+lb]. A single merge is batch 1; the
// batched multi-partition compaction (ops/batched_compact.py) merges one
// row per partition in the same launches, in place of the reference's
// jax.vmap. The key columns hold u32 values widened to int64; they are
// compared as u32 (pads 0xFFFFFFFF sort last). Ties take A first; in
// compaction they occur only among identical pad rows of one run, where
// any order writes the same bytes.
//
// What bounds it: the work is a single pass over memory (each input row
// read once, each output row written once, a few integer compares per
// row), so it is bound by device-memory bytes, not by operations. The
// keys of real tables share long prefixes (a hashkey's fixed leading
// bytes), so a compare that walks the key columns in device memory pays
// several scattered loads per decision. The design keeps both the
// searches and the compares out of device memory, as the reference does
// with its chunked VMEM merge:
//   1. partition (merge_path_splits_kernel): one thread per (row, tile
//      boundary) d_t = t * kTile binary-searches its merge-path split a_t
//      (a_t + b_t = d_t) over device memory and writes it to a scratch
//      array: one search per kTile outputs (the reference's
//      _diagonal_splits, :108-128). Each probe issues all its column
//      loads at once, so a step costs one memory latency;
//   2. merge (merge_path_tile_kernel): block (t, row) owns outputs
//      [d_t, d_t+1), whose inputs are exactly A[a_t, a_t+1) and
//      B[b_t, b_t+1). It finds the key columns in which the first and
//      last rows of both non-empty windows agree (both runs are sorted,
//      so every row of the tile agrees there) and skips them; stages the
//      remaining key columns of both windows into shared memory as u32
//      with coalesced loads; each thread searches its own diagonal and
//      merges kItems outputs there, recording tile-local 16-bit source
//      rows; the block then writes every column with consecutive threads
//      on consecutive addresses: skipped columns as their common value,
//      key columns widened from shared memory, payload columns gathered
//      from the two contiguous windows.
// Ties take A in both phases (the same strictness), so a tile boundary
// never splits equal rows of one run onto the wrong side. A batch row's
// offsets are computed in int64 (a full batch can exceed 2^31 values),
// and no thread or block reads outside its own row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxKeys = 10;  // key columns: 8 lanes + suffix rank + kp
constexpr int kSplitThreads = 128;
constexpr int kThreads = 256;  // threads per block of the merge kernel
constexpr int kItems = 8;      // outputs per thread
constexpr int kTile = kThreads * kItems;  // outputs per block

// strict B[j] < A[i] over the first nk columns, in device memory; every
// column's loads are issued before the first compare, so a probe costs
// one memory latency, not one per column walked
__device__ __forceinline__ bool b_less_a(const int64_t* __restrict__ a,
                                         int64_t la, int64_t i,
                                         const int64_t* __restrict__ b,
                                         int64_t lb, int64_t j, int nk) {
  uint32_t u[kMaxKeys];
  uint32_t v[kMaxKeys];
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < nk) {
      u[c] = static_cast<uint32_t>(b[c * lb + j]);
      v[c] = static_cast<uint32_t>(a[c * la + i]);
    }
  }
  bool less = false;
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kMaxKeys; ++c) {
    if (c < nk) {
      less = less || (eq && u[c] < v[c]);
      eq = eq && u[c] == v[c];
    }
  }
  return less;
}

// splits[row][t] = the number of A rows among the first
// min(t * kTile, la + lb) outputs of batch row `row`, t = 0..n_tiles: one
// thread per (row, boundary), a binary search along its diagonal
__global__ void __launch_bounds__(kSplitThreads)
merge_path_splits_kernel(const int64_t* __restrict__ a, int64_t la,
                         const int64_t* __restrict__ b, int64_t lb,
                         int n_cols, int nk, int64_t batch, int64_t n_tiles,
                         int64_t* __restrict__ splits) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kSplitThreads +
                    threadIdx.x;
  if (g >= batch * (n_tiles + 1)) return;
  const int64_t row = g / (n_tiles + 1);
  const int64_t t = g - row * (n_tiles + 1);
  a += row * n_cols * la;
  b += row * n_cols * lb;
  const int64_t total = la + lb;
  const int64_t d = t * kTile < total ? t * kTile : total;
  int64_t lo = d > lb ? d - lb : 0;
  int64_t hi = d < la ? d : la;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    // A[mid] precedes B[d-1-mid] unless B's row is strictly smaller
    if (!b_less_a(a, la, mid, b, lb, d - 1 - mid, nk)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  splits[g] = lo;
}

// strict row x < row y of a tile's staged key columns (column stride kTile)
__device__ __forceinline__ bool tile_less(const uint32_t* keys, int ncols,
                                          int x, int y) {
  for (int c = 0; c < ncols; ++c) {
    const uint32_t u = keys[c * kTile + x];
    const uint32_t v = keys[c * kTile + y];
    if (u != v) return u < v;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
merge_path_tile_kernel(const int64_t* __restrict__ a, int64_t la,
                       const int64_t* __restrict__ b, int64_t lb,
                       const int64_t* __restrict__ splits,
                       int64_t* __restrict__ out, int n_cols, int nk) {
  // blockIdx.y is the batch row: every pointer below is that row's
  const int64_t row = blockIdx.y;
  const int64_t total = la + lb;
  const int64_t n_tiles = (total + kTile - 1) / kTile;
  a += row * n_cols * la;
  b += row * n_cols * lb;
  out += row * n_cols * total;
  splits += row * (n_tiles + 1);

  // [nk - skip][kTile] staged key columns, each A's window then B's; then
  // src[kTile]: output k's row in that concatenated window (< na: A)
  extern __shared__ uint32_t keys[];
  uint16_t* src = reinterpret_cast<uint16_t*>(keys + nk * kTile);
  __shared__ int64_t head[kMaxKeys];  // the skipped columns' common values
  __shared__ int skip_s;

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  const int64_t a0 = splits[blockIdx.x];
  const int64_t b0 = d0 - a0;
  const int na = static_cast<int>(splits[blockIdx.x + 1] - a0);
  const int n = static_cast<int>(d1 - d0);
  const int nb = n - na;

  // common-prefix skip: lane c checks key column c at the windows' ends
  if (threadIdx.x < 32) {
    const int c = threadIdx.x;
    bool agree = false;
    if (c < nk) {
      const int64_t* ac = a + c * la + a0;
      const int64_t* bc = b + c * lb + b0;
      const int64_t v = na > 0 ? ac[0] : bc[0];
      agree = (na == 0 || ac[na - 1] == v) &&
              (nb == 0 || (bc[0] == v && bc[nb - 1] == v));
      head[c] = v;
    }
    const unsigned agreed = __ballot_sync(0xffffffffu, agree);
    if (c == 0) skip_s = __ffs(~agreed) - 1;  // lanes >= nk never agree
  }
  __syncthreads();
  const int skip = skip_s;
  const int nkw = nk - skip;

  // stage the remaining key columns, narrowed to u32
  for (int cc = 0; cc < nkw; ++cc) {
    const int64_t* ac = a + (skip + cc) * la + a0;
    const int64_t* bc = b + (skip + cc) * lb + b0;
    uint32_t v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int r = threadIdx.x + u * kThreads;
      v[u] = static_cast<uint32_t>(r < na ? ac[r] : (r < n ? bc[r - na] : 0));
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int r = threadIdx.x + u * kThreads;
      if (r < n) keys[cc * kTile + r] = v[u];
    }
  }
  __syncthreads();

  // each thread: its diagonal's split inside the tile, then kItems outputs
  const int k0 = threadIdx.x * kItems;
  if (k0 < n) {
    int lo = k0 > nb ? k0 - nb : 0;
    int hi = k0 < na ? k0 : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!tile_less(keys, nkw, na + k0 - 1 - mid, mid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo;
    int j = k0 - lo;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (k0 + u < n) {
        const bool take_a =
            j >= nb || (i < na && !tile_less(keys, nkw, na + j, i));
        src[k0 + u] = static_cast<uint16_t>(take_a ? i++ : na + j++);
      }
    }
  }
  __syncthreads();

  // write every column, consecutive threads on consecutive addresses
  for (int c = 0; c < n_cols; ++c) {
    int64_t* __restrict__ oc = out + c * total + d0;
    if (c < skip) {
      const int64_t v = head[c];
      for (int r = threadIdx.x; r < n; r += kThreads) oc[r] = v;
    } else if (c < nk) {
      const uint32_t* kc = keys + (c - skip) * kTile;
      for (int r = threadIdx.x; r < n; r += kThreads) {
        oc[r] = static_cast<int64_t>(kc[src[r]]);
      }
    } else {
      const int64_t* ac = a + c * la + a0;
      const int64_t* bc = b + c * lb + b0;
      int64_t v[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int r = threadIdx.x + u * kThreads;
        if (r < n) {
          const int s = src[r];
          v[u] = s < na ? ac[s] : bc[s - na];
        }
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int r = threadIdx.x + u * kThreads;
        if (r < n) oc[r] = v[u];
      }
    }
  }
}

bool supported(int nk) { return nk >= 1 && nk <= kMaxKeys; }

}  // namespace

// Both entries launch on `stream` (a cudaStream_t, PyTorch's current
// stream), do not synchronise and allocate nothing. They return the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for an
// nk above 10 or a batch outside 1..65535 (the grid's y extent). The
// caller validates shapes and types and allocates `splits` as int64
// [batch, ceil((la+lb)/2048)+1].

extern "C" int merge_path_splits_i64(const void* a, int64_t la,
                                     const void* b, int64_t lb, int n_cols,
                                     int nk, int64_t batch, void* splits,
                                     void* stream) {
  if (!supported(nk) || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (la + lb + kTile - 1) / kTile;
  const int64_t blocks =
      (batch * (n_tiles + 1) + kSplitThreads - 1) / kSplitThreads;
  merge_path_splits_kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), la, static_cast<const int64_t*>(b), lb,
      n_cols, nk, batch, n_tiles, static_cast<int64_t*>(splits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int merge_path_merge_i64(const void* a, int64_t la, const void* b,
                                    int64_t lb, const void* splits, void* out,
                                    int n_cols, int nk, int64_t batch,
                                    void* stream) {
  if (!supported(nk) || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (la + lb == 0) return 0;
  const dim3 blocks(static_cast<unsigned>((la + lb + kTile - 1) / kTile),
                    static_cast<unsigned>(batch));
  const size_t smem = static_cast<size_t>(nk) * kTile * sizeof(uint32_t) +
                      kTile * sizeof(uint16_t);
  // the kernel's opt-in limit is one value for every nk: merges of
  // different key widths launch from several host threads at once, and a
  // limit set to this launch's size could be lowered by another thread
  // between the set and the launch (cudaErrorInvalidValue)
  const size_t smem_max =
      static_cast<size_t>(kMaxKeys) * kTile * sizeof(uint32_t) +
      kTile * sizeof(uint16_t);
  const cudaError_t err = cudaFuncSetAttribute(
      merge_path_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_path_tile_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), la, static_cast<const int64_t*>(b), lb,
      static_cast<const int64_t*>(splits), static_cast<int64_t*>(out), n_cols,
      nk);
  return static_cast<int>(cudaGetLastError());
}
