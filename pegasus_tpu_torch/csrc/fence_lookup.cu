// Fence-bounded lexicographic lookup over a resident run, for Hopper
// (sm_90a).
//
// Replaces the XLA device program of pegasus_tpu/ops/device_lookup.py
// (_fence_lower_bound at :63, inside _compiled_lookup :138 and
// _compiled_range :217), which the port ran as ~1000 eager torch
// launches per probe (ops/device_lookup.py fence_lower_bound_plain).
// Here one launch resolves a whole probe.
//
// A resident run holds its sorted keys as w int64 lanes of u32 values
// plus a key length (cols [w, padded_len] with row stride `cols_stride`,
// klen [padded_len]); rows n..padded_len-1 are pads. Its fence
// [fence_len] holds every step-th first lane (fence_len * step >= n).
// Queries arrive packed in one buffer [n_sets, w + 1, q]: set s's lanes
// in rows 0..w-1, its key lengths in row w. For each query the kernel
// computes, as the plain version does:
//   1. a = searchsorted(fence, q0, left), b = searchsorted(fence, q0,
//      right) over the fence staged in shared memory;
//   2. the window lo = a > 0 ? min((a-1)*step, n-1) : 0,
//      hi = b < fence_len ? min(b*step, n-1) : n;
//   3. a lower_bound over (lanes..., klen) in [lo, hi), at most `steps`
//      halvings (the plain version's fixed depth; a round with an empty
//      window changes nothing, so the loop stops early);
// then, for point lookups (n_sets 1), the row if every lane and the
// length are equal, else -1 (int32 [q]); for ranges (n_sets 2: starts,
// stops), [lo, max(hi, lo)] (int32 [q, 2]).
//
// Values are u32 held in int64, so a signed int64 compare is the
// unsigned u32 order (lanes with the high bit set and 0xFFFFFFFF pads
// sort last). Gathers index as torch does: a negative index (only an
// empty run yields one) counts from the end.
//
// What bounds it: each query is a chain of dependent loads (two fence
// searches in shared memory, then one global probe of w+1 columns per
// halving), so a probe of few queries is bound by latency, not by bytes
// or operations. One thread per query; every lane of a probe is loaded
// before the first compare.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLanes = 16;
constexpr int kMaxFence = 4096;  // int64 entries: 32 KiB of shared memory

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t len) {
  return i < 0 ? i + len : i;
}

// first fence index whose value is >= v (upper: > v)
__device__ __forceinline__ int search(const int64_t* fence, int len,
                                      int64_t v, bool upper) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool go = upper ? fence[mid] <= v : fence[mid] < v;
    if (go) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Run {
  const int64_t* cols;
  int64_t cols_stride;
  const int64_t* klen;
  int w;
  int64_t padded_len;
  int64_t n;
  int64_t step;
  int fence_len;
  int steps;
};

// the plain version's lower_bound for one query (lanes q[0..w-1], len ql)
__device__ int64_t lower_bound(const Run& r, const int64_t* fence,
                               const int64_t* q, int64_t ql) {
  const int a = search(fence, r.fence_len, q[0], false);
  const int b = search(fence, r.fence_len, q[0], true);
  const int64_t n1 = r.n - 1;
  int64_t lo = a > 0 ? min((a - 1) * r.step, n1) : 0;
  const int64_t hi = b < r.fence_len ? min(b * r.step, n1) : r.n;
  int64_t length = hi - lo > 0 ? hi - lo : 0;
  for (int it = 0; it < r.steps && length > 0; ++it) {
    const int64_t half = length >> 1;
    const int64_t mid = lo + half;
    const int64_t row =
        wrap(mid < r.padded_len - 1 ? mid : r.padded_len - 1, r.padded_len);
    int64_t v[kMaxLanes + 1];
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      if (j < r.w) v[j] = r.cols[j * r.cols_stride + row];
    }
    const int64_t vl = r.klen[row];
    // strict row < query over (lanes..., klen)
    bool less = false, eq = true;
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      if (j < r.w) {
        less = less || (eq && v[j] < q[j]);
        eq = eq && v[j] == q[j];
      }
    }
    less = less || (eq && vl < ql);
    if (less) {
      lo = mid + 1;
      length = length - half - 1;
    } else {
      length = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
fence_lookup_kernel(Run r, const int64_t* __restrict__ fence,
                    const int64_t* __restrict__ queries, int64_t nq,
                    int n_sets, int32_t* __restrict__ out) {
  __shared__ int64_t s_fence[kMaxFence];
  for (int i = threadIdx.x; i < r.fence_len; i += kThreads) {
    s_fence[i] = fence[i];
  }
  __syncthreads();
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (qi >= nq) return;
  int64_t res[2];
  for (int s = 0; s < n_sets; ++s) {
    const int64_t* set = queries + static_cast<int64_t>(s) * (r.w + 1) * nq;
    int64_t q[kMaxLanes];
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      if (j < r.w) q[j] = set[j * nq + qi];
    }
    const int64_t ql = set[r.w * nq + qi];
    const int64_t lo = lower_bound(r, s_fence, q, ql);
    if (n_sets == 1) {
      // the point lookup's equality check on the row it landed on
      const int64_t safe = wrap(lo < r.padded_len - 1 ? lo : r.padded_len - 1,
                                r.padded_len);
      bool eq = lo < r.n;
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) {
        if (j < r.w) eq = eq && r.cols[j * r.cols_stride + safe] == q[j];
      }
      eq = eq && r.klen[safe] == ql;
      out[qi] = static_cast<int32_t>(eq ? lo : -1);
      return;
    }
    res[s] = lo;
  }
  out[2 * qi] = static_cast<int32_t>(res[0]);
  out[2 * qi + 1] = static_cast<int32_t>(res[1] > res[0] ? res[1] : res[0]);
}

}  // namespace

extern "C" int fence_lookup_i64(const void* cols, int64_t cols_stride,
                                const void* klen, int w, int64_t padded_len,
                                int64_t n, const void* fence, int fence_len,
                                int64_t step, int steps, const void* queries,
                                int64_t nq, int n_sets, void* out,
                                void* stream) {
  if (w < 1 || w > kMaxLanes || fence_len < 1 || fence_len > kMaxFence ||
      padded_len < 1 || (n_sets != 1 && n_sets != 2) || nq < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return 0;
  Run r{static_cast<const int64_t*>(cols), cols_stride,
        static_cast<const int64_t*>(klen), w, padded_len, n, step,
        fence_len, steps};
  const int64_t blocks = (nq + kThreads - 1) / kThreads;
  fence_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      r, static_cast<const int64_t*>(fence),
      static_cast<const int64_t*>(queries), nq, n_sets,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
