// Lexicographic lower_bound of a probe's queries over a resident run, for
// Hopper (sm_90a): a warp-cooperative (G + 1)-ary search.
//
// Replaces the XLA device program of pegasus_tpu/ops/device_lookup.py
// (_fence_lower_bound at :63, inside _compiled_lookup :138 and
// _compiled_range :217), which the port runs on CPU tensors as torch ops
// (ops/device_lookup.py fence_lookup_plain). One launch resolves a whole
// probe: for point lookups (n_sets 1) each query's row if every lane and
// the key length are equal, else -1 (int32 [q]); for ranges (n_sets 2:
// starts, stops) [lo, max(hi, lo)] (int32 [q, 2]).
//
// A resident run holds its sorted keys as w int64 lanes of u32 values
// plus a key length (cols [w, padded_len] with row stride `cols_stride`,
// klen [padded_len]); rows n..padded_len-1 are pads and are never read.
// Queries arrive packed in one buffer [n_sets, w + 1, q]: set s's lanes
// in rows 0..w-1, its key lengths in row w. Values are u32 held in int64,
// so a signed int64 compare is the unsigned u32 order.
//
// The answer is the reference's. The reference bounds each query's
// search by two probes of the run's fence (every step-th first lane) and
// runs a binary search of fixed depth in that window; on a sorted run
// the window always holds the lower_bound and the depth always reaches
// it, so the reference returns the run's exact lower_bound over (lanes,
// klen). This kernel computes that lower_bound over the whole run
// without the fence: the fence holds first lanes only, and a stored
// Pegasus key's first lane is the 2-byte hashkey length and two hashkey
// bytes ("\0\x13us" for every YCSB key), so on such runs the fence
// window is nearly the whole run and narrows nothing.
//
// What bounds it: a chain of dependent loads, not bytes or operations.
// One thread per query with a binary search waits on ~log2(n) loads of
// w + 1 columns in series (20 for a serve partition's 312 500 rows).
// Here a group of G lanes serves one query. In each round lane i loads
// the full key of pivot i of G evenly spaced pivots of the window [lo,
// hi) and compares it with the query; the ballot's count c of pivots
// below the query picks the sub-window between pivots c - 1 and c, which
// is at most ceil(len / (G + 1)) rows. When fewer than G rows remain, the
// last round loads rows lo..hi, one per lane (adjacent rows, coalesced
// column by column): the lower_bound is lo plus the count of rows below
// the query, and the lane holding that row already has its equality in
// registers, so a point lookup needs no further load. With G = 32 a
// window of 312 500 rows takes 4 dependent rounds (3 of pivots and the
// last), 10 M rows 5. Every load of a round is issued before its first
// compare. G is 32 or 8, by the probe's size (ops/fence_lookup.py
// group_for): a probe of up to 1024 queries waits on the chain, and 32
// lanes make it shortest; a larger one is bound by the sectors its
// pivot loads move, and 8 lanes (6 rounds at 312 500 rows) move a
// quarter of them. The two sets of a range query run in two groups of
// one block at once and meet in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLanes = 16;

struct Run {
  const int64_t* __restrict__ cols;
  int64_t cols_stride;
  const int64_t* __restrict__ klen;
  int w;
  int64_t n;
};

// row's key (lanes, then klen) against the query's: -1 below, 0 equal,
// 1 above; every load is issued before the first compare
__device__ __forceinline__ int compare_row(const Run& r, int64_t row,
                                           const int64_t* q, int64_t ql) {
  int64_t v[kMaxLanes];
#pragma unroll
  for (int j = 0; j < kMaxLanes; ++j) {
    if (j < r.w) v[j] = __ldg(r.cols + j * r.cols_stride + row);
  }
  const int64_t vl = __ldg(r.klen + row);
  int cmp = 0;
#pragma unroll
  for (int j = 0; j < kMaxLanes; ++j) {
    if (j < r.w && cmp == 0) cmp = v[j] < q[j] ? -1 : (v[j] > q[j] ? 1 : 0);
  }
  if (cmp == 0) cmp = vl < ql ? -1 : (vl > ql ? 1 : 0);
  return cmp;
}

// The group's lower_bound of one query over rows [0, n), and whether the
// row it lands on equals the query. `sub` is the lane's index in its
// group, `shift` the group's first lane in the warp, `gmask` its lanes.
// lo, hi and every count are the same in all lanes of a group.
template <int G>
__device__ __forceinline__ int64_t group_lower_bound(
    const Run& r, const int64_t* q, int64_t ql, int sub, int shift,
    unsigned gmask, bool* hit) {
  constexpr unsigned kLow = G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
  // the lower_bound lies in [lo, hi]; rows in [lo, hi) are not yet known
  int64_t lo = 0, hi = r.n > 0 ? r.n : 0;
  while (hi - lo >= G) {
    const int64_t len = hi - lo;
    const int64_t pivot = lo + (static_cast<int64_t>(sub + 1) * len) / (G + 1);
    const bool below = compare_row(r, pivot, q, ql) < 0;
    // pivots ascend with the lane, so the ones below the query come first
    const int c = __popc((__ballot_sync(gmask, below) >> shift) & kLow);
    const int64_t next_lo =
        c == 0 ? lo : lo + (static_cast<int64_t>(c) * len) / (G + 1) + 1;
    if (c < G) hi = lo + (static_cast<int64_t>(c + 1) * len) / (G + 1);
    lo = next_lo;
  }
  // last round: hi - lo < G, so rows lo..hi fit one per lane (row hi,
  // known not below the query, is loaded only for the equality)
  const int64_t row = lo + sub;
  int cmp = 1;
  if (row <= hi && row < r.n) cmp = compare_row(r, row, q, ql);
  const unsigned below = (__ballot_sync(gmask, cmp < 0 && row < hi) >> shift)
                         & kLow;
  const unsigned equal = (__ballot_sync(gmask, cmp == 0) >> shift) & kLow;
  const int c = __popc(below);
  *hit = (equal >> c) & 1u;
  return lo + c;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
fence_search_kernel(Run r, const int64_t* __restrict__ queries, int64_t nq,
                    int n_sets, int32_t* __restrict__ out) {
  constexpr int kGroups = kThreads / G;   // even: a range's two sets meet
  __shared__ int64_t s_lo[kGroups];
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int shift = lane - sub;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << shift;
  const int group = threadIdx.x / G;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kGroups + group;
  const int64_t qi = g / n_sets;
  const int s = static_cast<int>(g % n_sets);
  const bool active = qi < nq;
  int64_t lo = 0;
  bool hit = false;
  if (active) {
    const int64_t* set = queries + static_cast<int64_t>(s) * (r.w + 1) * nq;
    int64_t q[kMaxLanes];
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      if (j < r.w) q[j] = __ldg(set + j * nq + qi);
    }
    const int64_t ql = __ldg(set + r.w * nq + qi);
    lo = group_lower_bound<G>(r, q, ql, sub, shift, gmask, &hit);
  }
  if (n_sets == 1) {
    if (active && sub == 0) out[qi] = static_cast<int32_t>(hit ? lo : -1);
    return;
  }
  if (sub == 0) s_lo[group] = lo;
  __syncthreads();
  if (active && sub == 0 && s == 1) {
    // a stop below the start (empty/inverted range) clamps to empty
    const int64_t start = s_lo[group - 1];
    out[2 * qi] = static_cast<int32_t>(start);
    out[2 * qi + 1] = static_cast<int32_t>(lo > start ? lo : start);
  }
}

template <int G>
void launch(const Run& r, const int64_t* queries, int64_t nq, int n_sets,
            int32_t* out, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int64_t blocks = (nq * n_sets + kGroups - 1) / kGroups;
  fence_search_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(r, queries, nq, n_sets, out);
}

}  // namespace

extern "C" int fence_lookup_i64(const void* cols, int64_t cols_stride,
                                const void* klen, int w, int64_t n,
                                const void* queries, int64_t nq, int n_sets,
                                int group, void* out, void* stream) {
  if (w < 1 || w > kMaxLanes || n < 0 || n > INT32_MAX ||
      (n_sets != 1 && n_sets != 2) || nq < 0 ||
      (group != 8 && group != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return 0;
  const Run r{static_cast<const int64_t*>(cols), cols_stride,
              static_cast<const int64_t*>(klen), w, n};
  const auto* qs = static_cast<const int64_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (group == 8) {
    launch<8>(r, qs, nq, n_sets, o, s);
  } else {
    launch<32>(r, qs, nq, n_sets, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}
