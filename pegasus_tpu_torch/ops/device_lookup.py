"""Batched point and range lookups over device-resident SST key columns.

Flush and compaction prime each run's packed key columns onto the device
(DeviceRun, ops/compact.py). This module serves reads from the same
resident data:

  1. A per-SST FENCE index (`build_fence_index`), computed on the device
     from the sorted first key lane as a byproduct of the prime: every
     `step`-th first-lane value is sampled into a small fence tensor. A
     query's two searchsorted probes against it bound its position to
     one `step`-sized block of the run.
  2. `lookup_batch`: queries are packed into the run's prefix lanes (the
     packing the merge keys use; a resident run holds the FULL key in its
     lanes, so lane+klen equality is full-key equality), fenced, then
     resolved with a fixed-depth binary search. Returns each query's row
     index in the run, or -1.
  3. `range_batch`: the same fence-bounded lower_bound over a batch of
     (start, stop) bounds, resolving each range to the run's contiguous
     row interval [lo, hi).

On a CUDA run a probe is one upload of the packed queries, one launch
of the hand-written fence-lookup kernel (csrc/fence_lookup.cu, through
ops/fence_lookup.py) and one download; a CPU run takes the kernel's
plain version in torch ops (fence_lookup_plain).

The device returns INDICES only; the host materializes values from the
SST's cached block exactly like the host binary search does, so the
device path is byte-identical to `SSTable.find` / `lower_bound` by
construction. A device failure raises to the caller.
"""

import numpy as np
import torch

from ..runtime.tracing import COMPACT_TRACER as _TRACE
from . import fence_lookup as _kernel
from .compact import _pow2ceil
from .device_sort import lex_less
from .packing import pack_key_prefixes

_FENCE_MAX = 4096     # fence entries per run


def fence_lower_bound_plain(dr, qcols: torch.Tensor,
                           qklen: torch.Tensor) -> torch.Tensor:
    """Fence probe -> fixed-depth vectorized lower_bound over the full
    (prefix lanes, klen) sort key, as eager torch ops: the plain version
    of the fence-lookup kernel (csrc/fence_lookup.cu). Returns each
    query's lower_bound row in [0, n]. Runs hold the FULL key in their
    lanes, so lane/klen lex order IS byte order and the result matches
    SSTable.lower_bound, including for queries LONGER than the 4*w-byte
    window: such a query's lane image ties only with rows that are proper
    byte prefixes of it, and the klen tie-break orders those below the
    query, as bytes do."""
    n, step, padded_len = dr.n, dr.fence_step, dr.padded_len
    q0 = qcols[0].contiguous()
    # rows before sample a-1 are < q0, rows from sample b on are > q0, so
    # the full-key lower_bound lies in [lo, hi)
    a = torch.searchsorted(dr.fence, q0, side="left")
    b = torch.searchsorted(dr.fence, q0, side="right")
    lo = torch.where(a > 0, ((a - 1) * step).clamp(max=n - 1), 0)
    hi = torch.where(b < dr.fence_len, (b * step).clamp(max=n - 1), n)
    length = (hi - lo).clamp(min=0)
    qkey = list(qcols) + [qklen]
    for _ in range(lookup_steps(dr)):
        half = length >> 1
        mid = lo + half
        midc = mid.clamp(max=padded_len - 1)
        row = [dr.cols[j][midc] for j in range(dr.w)] + [dr.klen[midc]]
        less = lex_less(row, qkey)
        active = length > 0
        lo = torch.where(active & less, mid + 1, lo)
        length = torch.where(active, torch.where(less, length - half - 1,
                                                 half), 0)
    return lo


def lookup_steps(dr) -> int:
    """The lower_bound's fixed depth (the reference's
    max(1, padded_len.bit_length()))."""
    return max(1, dr.padded_len.bit_length())


def fence_lookup_plain(dr, packed: torch.Tensor) -> torch.Tensor:
    """The fence lookup of one probe in torch ops. `packed` is the int64
    [n_sets, w + 1, q] query buffer (pack_queries): one set of point
    queries -> int32 [q], each query's row or -1; two sets (starts,
    stops) -> int32 [q, 2], each range's [lo, max(hi, lo)]."""
    w = dr.w
    los = [fence_lower_bound_plain(dr, packed[s, :w], packed[s, w])
           for s in range(packed.shape[0])]
    if len(los) == 2:
        # a stop below the start (empty/inverted range) clamps to empty
        return torch.stack([los[0], torch.maximum(los[1], los[0])],
                           dim=1).to(torch.int32)
    lo = los[0]
    safe = lo.clamp(max=dr.padded_len - 1)
    eq = lo < dr.n
    for j in range(w):
        eq &= dr.cols[j][safe] == packed[0, j]
    eq &= dr.klen[safe] == packed[0, w]
    return torch.where(eq, lo, -1).to(torch.int32)


def fence_lookup(dr, packed: torch.Tensor) -> torch.Tensor:
    """The fence lookup of one probe (see fence_lookup_plain): the
    hand-written kernel on a CUDA run, the plain version on a CPU one."""
    if dr.cols.device.type != "cuda":
        return fence_lookup_plain(dr, packed)
    return _kernel.launch(dr, packed, lookup_steps(dr))


def build_fence_index(dr) -> None:
    """Attach the fence index to a DeviceRun in place (fields `fence`,
    `fence_step`, `fence_len`), gathered on the device from the resident
    first key lane."""
    fence_len = min(_FENCE_MAX, _pow2ceil(max(1, dr.n // 8), 16))
    step = -(-dr.n // fence_len)  # ceil: fence_len * step >= n
    pos = torch.arange(fence_len, device=dr.cols.device) * step
    dr.fence = dr.cols[0][pos.clamp(max=dr.n - 1)].contiguous()
    dr.fence_step = step
    dr.fence_len = fence_len


def pack_queries(key_sets, w: int, device) -> torch.Tensor:
    """Host-side packing of query key lists (one list per set, equal
    lengths) into a run's lane layout: one int64 [n_sets, w + 1, q]
    tensor on `device` (lanes in rows 0..w-1, key lengths in row w), one
    upload. A query longer than the run's 4*w-byte window truncates in
    the lanes but keeps its true klen: it can never equal a resident key
    (all <= 4*w bytes), so the equality check returns -1 for it, the
    correct answer."""
    nq = len(key_sets[0])
    buf = np.empty((len(key_sets), w + 1, nq), np.int64)
    for s, keys in enumerate(key_sets):
        arena = np.frombuffer(b"".join(keys), dtype=np.uint8).copy() \
            if nq else np.zeros(0, np.uint8)
        lens = np.fromiter((len(k) for k in keys), dtype=np.int64,
                           count=nq)
        offs = np.zeros(nq, dtype=np.int64)
        if nq:
            np.cumsum(lens[:-1], out=offs[1:])
        buf[s, :w] = pack_key_prefixes(arena, offs, lens, w).T
        buf[s, w] = lens
    return torch.from_numpy(buf).to(device)


def lookup_batch(dr, keys) -> np.ndarray:
    """Probe `keys` (full stored keys, any order) against one resident
    run. -> np.int32[len(keys)]: the run row of each exact match, -1 for
    absent keys."""
    if not keys or dr is None or dr.fence is None:
        return np.full(len(keys), -1, np.int32)
    with _TRACE.span("read.lookup", records=len(keys)):
        packed = pack_queries([keys], dr.w, dr.cols.device)
        return fence_lookup(dr, packed).cpu().numpy()


def range_batch(dr, ranges) -> np.ndarray:
    """Resolve each (start_key, stop_key) query against one resident run:
    -> np.int32[(len(ranges), 2)], each row the run's contiguous row
    interval [lo, hi) holding exactly the keys in [start, stop). stop_key
    None means "to the end of the run". Both bounds resolve in one
    probe."""
    nq = len(ranges)
    if not nq or dr is None or dr.fence is None:
        return np.zeros((nq, 2), np.int32)
    starts = [s for s, _ in ranges]
    stops = [(t if t is not None else b"") for _, t in ranges]
    open_stop = np.fromiter((t is None for _, t in ranges),
                            dtype=bool, count=nq)
    with _TRACE.span("read.range", records=nq):
        packed = pack_queries([starts, stops], dr.w, dr.cols.device)
        iv = fence_lookup(dr, packed).cpu().numpy()
    # a None stop packed as b"" would lower_bound to 0; patch to run end
    iv[open_stop, 1] = dr.n
    return iv
