"""Sort / k-way merge / filter: the compaction_backend={cpu,cuda} pipeline.

The work RocksDB does record-at-a-time inside CompactRange (comparator
sort, level merge, TTL/version dedup filtering) runs here as batched
passes over KVBlock columns:

  1. merge of already-sorted runs into full byte order of stored keys,
     newest run first within equal keys. The cpu backend computes the
     merge permutation from each run pair's ranks, counted in one C pass
     over both runs (native.merge_counts; its twin is np.searchsorted);
     the cuda backend merges runs pairwise on the device with the
     merge-path kernel (ops/merge_path.py).
  2. dedup: keep only the first (= newest) version of each key;
  3. filter: drop expired-TTL records, tombstones at the bottommost
     level, and keys no longer owned by this partition after a split.

Both backends implement identical semantics on the same total order, so
output SSTs are byte-identical across cpu/cuda and with the JAX package:
learner checksums and backup digests only agree when every backend
writes the same bytes.

The device pipeline returns survivor indices (into the concatenated
input) in sorted order. Variable-length key/value bytes never touch the
device: the host gathers arenas by those indices.

Uniqueness contract: within one run, keys are unique (a memtable is a
map, an SST is a deduped flush/compaction output). Across runs,
duplicates are expected and resolved newest-run-first.

Device columns are int64 (see ops/device_sort.py). Runs keep the JAX
package's padding layout: pow2 buckets >= 256 rows, key pads 0xFFFFFFFF,
gidx pads -1, aux pads 0.
"""

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import native
from ..base.utils import epoch_now
from ..engine.block import KVBlock
from ..runtime.fail_points import inject
from ..runtime.tracing import COMPACT_TRACER as _TRACE
from .merge_path import merge_two_sorted
from .packing import (DEFAULT_PREFIX_U32, compute_suffix_ranks,
                      pack_key_prefixes, pack_sbytes)
from .pipeline import CompactPipeline, pipeline_depth

_U32_MAX = 0xFFFFFFFF
_MIN_BUCKET = 256  # runs pad to pow2 buckets >= this (the reference layout)


def resolve_device(device) -> torch.device:
    """None means the card: the port runs on CUDA unless the caller asks
    for another device."""
    return torch.device("cuda" if device is None else device)


@dataclass
class CompactOptions:
    now: int = None                # epoch (2016-based) seconds; default wall clock
    pidx: int = 0                  # this partition's index
    partition_mask: int = 0        # partition_version mask; 0 = no split GC
    bottommost: bool = True        # tombstones may be dropped only at bottom
    filter: bool = True            # False = flush path (pure sort, no drops)
    default_ttl: int = 0           # table-level default_ttl app-env (seconds)
    prefix_u32: int = DEFAULT_PREFIX_U32   # max prefix window, in u32 lanes
    backend: str = "cuda"          # "cuda" | "cpu"
    device: object = None          # cuda backend's device; None = "cuda"
    runs_sorted: bool = None       # None = detect; True skips the host check
    user_ops: tuple = ()           # engine.compaction_rules Operations
    # device merges of more records than this split into disjoint key
    # ranges that compact one after another (the blockwise path). Sized
    # for an 80 GB card: runs pad to powers of two, so 2x worst-case
    # padding gives 134 M padded rows, and at 455 B per padded row at
    # pipeline depth 2 (measured on an NVIDIA H100 80GB HBM3 at 700 W,
    # PERF.md) that is 61 GB. The JAX package's default is 128 << 20.
    max_device_records: int = 64 << 20

    def resolved_now(self) -> int:
        return epoch_now() if self.now is None else self.now


@dataclass
class CompactResult:
    block: KVBlock
    stats: dict = field(default_factory=dict)


def _pow2ceil(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _u32_pad(a: np.ndarray, n: int) -> np.ndarray:
    """u32 column -> int64[n], pad rows 0xFFFFFFFF (sort after all keys)."""
    out = np.full(n, _U32_MAX, dtype=np.int64)
    out[: len(a)] = a
    return out


def _zpad(a: np.ndarray, n: int, dtype) -> np.ndarray:
    out = np.zeros(n, dtype=dtype)
    out[: len(a)] = a
    return out


def _prefix_width(max_klen: int, prefix_u32: int) -> int:
    return max(1, min(-(-min(max_klen, 4 * prefix_u32) // 4), prefix_u32))


@dataclass
class PackedRuns:
    """Host-side packed state for one compaction: per-run fixed-width sort
    columns plus the auxiliary columns the filters need. Runs are
    newest-first; each run is ascending by key after packing (unsorted
    inputs are locally argsorted here, remapping gidx)."""

    w: int                      # prefix lanes actually used
    has_rank: bool
    cols: list                  # per run: list of w uint32[n_i] prefix cols
    rank: list                  # per run: uint32[n_i] or None
    klen: list                  # per run: uint32[n_i]
    gidx: list                  # per run: int32[n_i] global concat index
    sbytes: list                # per run: S-dtype[n_i] (may hold None)
    lens: tuple                 # per run real lengths
    blocks: list                # the source KVBlocks (for lazy global aux)
    run_aux: list               # per run: (expire, deleted, hash32) in ROW
                                # order: the device folds the filters
                                # elementwise before the merge

    # global-index-order aux, built lazily: only the cpu backend's
    # post-merge filter reads these
    @property
    def expire(self) -> np.ndarray:
        if self._expire is None:
            self._expire = np.concatenate([b.expire_ts for b in self.blocks])
        return self._expire

    @property
    def deleted(self) -> np.ndarray:
        if self._deleted is None:
            self._deleted = np.concatenate([b.deleted for b in self.blocks])
        return self._deleted

    @property
    def hash32(self) -> np.ndarray:
        if self._hash32 is None:
            self._hash32 = np.concatenate([b.hash32 for b in self.blocks])
        return self._hash32

    def __post_init__(self):
        self._expire = self._deleted = self._hash32 = None


def pack_runs(runs, opts: CompactOptions, need_sbytes: bool) -> PackedRuns:
    with _TRACE.span("pack", records=sum(b.n for b in runs),
                     nbytes=sum(b.key_bytes_total + b.val_bytes_total
                                for b in runs)):
        return _pack_runs_impl(runs, opts, need_sbytes)


def _pack_runs_impl(runs, opts: CompactOptions,
                    need_sbytes: bool) -> PackedRuns:
    max_klen = max(int(b.key_len.max()) for b in runs)
    if max_klen >= 1 << 24:
        raise ValueError("keys >= 16MiB unsupported")
    w = _prefix_width(max_klen, opts.prefix_u32)
    has_rank = max_klen > 4 * w
    ranks_all = None
    if has_rank:
        ranks_all = compute_suffix_ranks(KVBlock.concat(runs), w)
    offsets = np.cumsum([0] + [b.n for b in runs])
    cols, rank_l, klen_l, gidx_l, sb_l, aux_l = [], [], [], [], [], []
    sorted_known = bool(opts.runs_sorted)
    for i, b in enumerate(runs):
        pref = pack_key_prefixes(b.key_arena, b.key_off, b.key_len, w)
        kl = b.key_len.astype(np.uint32)
        rk = ranks_all[offsets[i]: offsets[i + 1]] if has_rank else None
        gi = np.arange(offsets[i], offsets[i + 1], dtype=np.int32)
        ex, de, hs = b.expire_ts, b.deleted, b.hash32
        sb = None
        if need_sbytes or not sorted_known:
            sb = pack_sbytes([pref[:, j] for j in range(w)], kl, rk)
            if not sorted_known and not _is_sorted(sb):
                order = np.argsort(sb, kind="stable")
                pref, kl, gi, sb = pref[order], kl[order], gi[order], sb[order]
                ex, de, hs = ex[order], de[order], hs[order]
                if rk is not None:
                    rk = rk[order]
        # runs that violate intra-run uniqueness (tests, raw external sets)
        # get first-wins dedup HERE, on every backend: the device merge is
        # not stable, so duplicate (key, prio) rows would survive
        # nondeterministically. Sorted runs have duplicates adjacent.
        n_run = len(kl)
        dup = np.zeros(n_run, dtype=bool)
        if sb is not None:
            dup[1:] = sb[1:] == sb[:-1]
        elif n_run > 1:
            same = np.all(pref[1:] == pref[:-1], axis=1) & (kl[1:] == kl[:-1])
            if rk is not None:
                same &= rk[1:] == rk[:-1]
            dup[1:] = same
        if dup.any():
            keep_rows = ~dup
            pref, kl, gi = pref[keep_rows], kl[keep_rows], gi[keep_rows]
            ex, de, hs = ex[keep_rows], de[keep_rows], hs[keep_rows]
            if sb is not None:
                sb = sb[keep_rows]
            if rk is not None:
                rk = rk[keep_rows]
        cols.append([np.ascontiguousarray(pref[:, j]) for j in range(w)])
        rank_l.append(rk)
        klen_l.append(kl)
        gidx_l.append(gi)
        sb_l.append(sb)
        aux_l.append((ex, de, hs))
    return PackedRuns(
        w=w, has_rank=has_rank, cols=cols, rank=rank_l, klen=klen_l,
        gidx=gidx_l, sbytes=sb_l,
        # post-dedup lengths (gidx still indexes the ORIGINAL concat)
        lens=tuple(len(g) for g in gidx_l),
        blocks=list(runs), run_aux=aux_l,
    )


def _is_sorted(sb: np.ndarray) -> bool:
    return bool(np.all(sb[1:] >= sb[:-1])) if len(sb) > 1 else True


def _filter_keep(keep, gidx, packed: PackedRuns, now, pidx, pmask,
                 bottommost):
    expire = packed.expire[gidx]
    keep &= ~((expire > 0) & (expire <= now))
    if pmask:
        keep &= (packed.hash32[gidx] & np.uint32(pmask)) == np.uint32(pidx)
    if bottommost:
        keep &= ~packed.deleted[gidx]
    return keep


def merge_counts_plain(a, b, side: str) -> np.ndarray:
    """native.merge_counts' numpy twin: a binary search per item of a."""
    return np.searchsorted(b, a, side=side)


class CpuBackend:
    """Vectorized host merge: each record's merged rank = own position +
    count of smaller records in every other run (native.merge_counts),
    then a scatter materializes the merge."""

    name = "cpu"

    def survivors(self, packed: PackedRuns, now, pidx, pmask, bottommost,
                  do_filter) -> np.ndarray:
        with _TRACE.span("device", records=sum(packed.lens)):
            return self._survivors(packed, now, pidx, pmask, bottommost,
                                   do_filter)

    def _survivors(self, packed: PackedRuns, now, pidx, pmask, bottommost,
                   do_filter) -> np.ndarray:
        K = len(packed.lens)
        if K == 1:
            merged_sb, merged_gidx = packed.sbytes[0], packed.gidx[0]
        else:
            total = sum(packed.lens)
            merged_sb = np.empty(total, dtype=packed.sbytes[0].dtype)
            merged_gidx = np.empty(total, dtype=np.int32)
            for i in range(K):
                r = np.arange(packed.lens[i], dtype=np.int64)
                for j in range(K):
                    if j == i:
                        continue
                    # equal keys order newest-run (lowest index) first
                    side = "right" if j < i else "left"
                    r += native.merge_counts(packed.sbytes[i],
                                             packed.sbytes[j], side)
                merged_sb[r] = packed.sbytes[i]
                merged_gidx[r] = packed.gidx[i]
        same = np.zeros(len(merged_sb), dtype=bool)
        same[1:] = merged_sb[1:] == merged_sb[:-1]
        keep = ~same
        if do_filter:
            keep = _filter_keep(keep, merged_gidx, packed, now, pidx, pmask,
                                bottommost)
        return merged_gidx[keep]


@dataclass
class DevicePacked:
    """Host-packed compaction inputs uploaded for one merge."""

    run_cols: tuple   # per run: (int64 [nkc, P] key cols, klen [P], gidx [P])
    aux: tuple        # per run: (expire, deleted, hash32), ROW-aligned, padded
    padded_lens: tuple
    w: int
    has_rank: bool


@dataclass
class DeviceRun:
    """One run's device-resident packed columns: an SSTable packs and
    uploads these ONCE (flush prime or first device compaction) and every
    later compaction it joins reads device memory, not the host. Runs
    whose keys exceed the prefix window (suffix-rank merges) are not
    cacheable: ranks are global to a merge set.

    Every column is padded to the pow2 bucket (pads: keys 0xFFFFFFFF,
    aux 0)."""

    cols: torch.Tensor     # int64 [w, padded_len]
    klen: torch.Tensor     # int64 [padded_len]
    expire: torch.Tensor   # int64 [padded_len]
    deleted: torch.Tensor  # bool [padded_len]
    hash32: torch.Tensor   # int64 [padded_len]
    n: int
    padded_len: int
    w: int
    # value residency (uniform-layout runs only): the run's value rows
    # live on the device too, so compaction output values gather there
    val2d: torch.Tensor = None   # uint8 [padded_len, vl0] or None
    vl0: int = 0
    # per-SST read index (ops/device_lookup.py build_fence_index)
    fence: torch.Tensor = None   # int64 [fence_len] or None
    fence_step: int = 0
    fence_len: int = 0

    def nbytes(self) -> int:
        base = (self.w + 3) * 8 * self.padded_len + self.padded_len
        if self.val2d is not None:
            base += self.padded_len * self.vl0
        if self.fence is not None:
            base += 8 * self.fence_len
        return base


def pack_run_device(block, prefix_u32: int = DEFAULT_PREFIX_U32,
                    with_values: bool = False, device=None):
    """-> DeviceRun on `device` (None = "cuda"), or None when this run
    cannot be cached (keys longer than the prefix window need per-merge
    suffix ranks). The run must be sorted (SSTs are born sorted).
    with_values additionally pins the value rows when the layout is
    uniform (value residency)."""
    device = resolve_device(device)
    if block.n == 0:
        return None
    max_klen = int(block.key_len.max())
    w = _prefix_width(max_klen, prefix_u32)
    if max_klen > 4 * w:
        return None
    n = block.n
    padded = _pow2ceil(n, _MIN_BUCKET)
    with _TRACE.span("pack", records=n):
        pref = pack_key_prefixes(block.key_arena, block.key_off,
                                 block.key_len, w)
        cols = np.full((w, padded), _U32_MAX, dtype=np.int64)
        cols[:, :n] = pref.T
        host = [cols, _u32_pad(block.key_len, padded),
                _zpad(block.expire_ts, padded, np.int64),
                _zpad(block.deleted, padded, np.bool_),
                _zpad(block.hash32, padded, np.int64)]
        rows = None
        uni = block.uniform_layout() if with_values else None
        if uni is not None:
            rows = np.zeros((padded, uni[1]), np.uint8)
            rows[:n] = block.val_arena.reshape(n, uni[1])
    nbytes = sum(a.nbytes for a in host) + (rows.nbytes if rows is not None
                                            else 0)
    with _TRACE.span("h2d", records=n, nbytes=nbytes):
        inject("compact.h2d")
        t = [torch.from_numpy(a).to(device) for a in host]
        val2d = torch.from_numpy(rows).to(device) if rows is not None \
            else None
    dr = DeviceRun(cols=t[0], klen=t[1], expire=t[2], deleted=t[3],
                   hash32=t[4], n=n, padded_len=padded, w=w, val2d=val2d,
                   vl0=uni[1] if uni is not None else 0)
    # the read index is a byproduct of the prime: the sorted first key
    # lane is on the device right now
    from .device_lookup import build_fence_index

    build_fence_index(dr)
    return dr


def _pipeline_body(runs, aux_runs, padded_lens, nk, now, pidx, pmask,
                   bottommost, do_filter):
    """merge -> dedup -> filter -> compact over a leading batch axis of B
    independent merges (one per partition in the batched path; B = 1 for
    a single merge), shared by the host-packed and the device-cached
    entry points.

    runs[i] = (kcols int64 [B, nk-1, P_i], klen [B, P_i], idx [B, P_i]).
    Sort key per record: (prefix lanes, [suffix rank,] klen<<8|prio). Pads
    carry 0xFFFFFFFF keys / idx -1 and sort to the tail of every merge;
    the idx >= 0 guard at the end excludes them.

    aux_runs[i] holds run i's ROW-aligned (expire, deleted, hash32), each
    [B, P_i]: the TTL/stale/tombstone filter folds into the idx column
    BEFORE the merge (filtered rows get idx -1). pidx is an int or a
    [B, 1] tensor (each batch row's own partition). A key's duplicates
    are masked by `same` regardless of the newest version's filter bit,
    so a filtered newest version still shadows (and drops) its older
    versions.

    -> (out_idx int64 [B, sum P_i]: each row's survivors first, then -1;
    counts int64 [B] on the device)."""
    items = []
    for i, (kcols, klen, idx) in enumerate(runs):
        if do_filter:
            expire, deleted, hash32 = aux_runs[i]
            filt = (expire > 0) & (expire <= now)
            if pmask > 0:
                filt = filt | ((hash32 & pmask) != pidx)
            if bottommost:
                filt = filt | deleted
            idx = torch.where(filt, -1, idx)
        # u32 arithmetic as in the reference: pads (klen 0xFFFFFFFF) wrap
        kp = ((klen << 8) & _U32_MAX) | i
        items.append((padded_lens[i],
                      torch.cat([kcols, kp[:, None], idx[:, None]], dim=1)))
    # merge smallest-first; the list sort is stable, so equal lengths keep
    # their order, as in the reference
    while len(items) > 1:
        items.sort(key=lambda t: t[0])
        (la, a), (lb, b) = items[0], items[1]
        items = items[2:] + [(la + lb, merge_two_sorted(a, b, nk))]
    cols = items[0][1]
    idx = cols[:, nk]
    batch, n = idx.shape
    same = torch.zeros((batch, n), dtype=torch.bool, device=idx.device)
    if n > 1:
        kp_key = cols[:, nk - 1] >> 8   # run priority stripped
        same[:, 1:] = ((cols[:, : nk - 1, 1:] == cols[:, : nk - 1, :-1])
                       .all(dim=1) & (kp_key[:, 1:] == kp_key[:, :-1]))
    keep = (idx >= 0) & ~same
    pos = torch.cumsum(keep, dim=1) - 1
    counts = pos[:, -1] + 1
    tgt = torch.where(keep, pos, n)
    out_idx = torch.full((batch, n + 1), -1, dtype=torch.int64,
                         device=idx.device)
    out_idx.scatter_(1, tgt, idx)
    return out_idx[:, :n], counts


def _make_cached_fn(padded_lens: tuple, run_ws: tuple, w: int):
    """The pipeline over CACHED device runs (DeviceRun columns, packed and
    uploaded once when the SST was born or first joined a device merge),
    over a leading batch axis as _pipeline_body.

    Everything a specific merge needs beyond the cached columns is derived
    here, per batch row on the device: missing prefix lanes for runs with
    shorter keys (0 in the run, 0xFFFFFFFF in the pad tail) and each
    record's index in its row's real concat (what the host gather
    indexes), which the merge carries as its payload. A run's pad rows
    are those whose klen holds the pad 0xFFFFFFFF (real keys are shorter
    than 16 MiB). real_off [B, K] (a device tensor, _real_offsets per
    row) holds where each run starts in its row's real concat; pidx is an
    int or a [B, 1] tensor."""
    nk = w + 1  # cached runs never carry a suffix-rank column

    def fn(cached_runs, aux_runs, real_off, now, pidx, pmask, bottommost,
           do_filter):
        runs = []
        for i, (kcols, klen) in enumerate(cached_runs):
            in_run = klen != _U32_MAX
            if w > run_ws[i]:
                extra = torch.where(in_run, 0, _U32_MAX)
                kcols = torch.cat(
                    [kcols, extra[:, None].expand(-1, w - run_ws[i], -1)],
                    dim=1)
            iota = torch.arange(padded_lens[i], device=klen.device)
            gidx = torch.where(in_run, iota + real_off[:, i: i + 1], -1)
            runs.append((kcols, klen, gidx))
        return _pipeline_body(runs, aux_runs, padded_lens, nk, now, pidx,
                              pmask, bottommost, do_filter)

    return fn


def _real_offsets(device_runs) -> list:
    """Where each run starts in the concat of the runs' real rows."""
    return np.cumsum([0] + [r.n for r in device_runs[:-1]]).tolist()


class CudaBackend:
    """The device pipeline on one torch device. On a CUDA device the
    merges run through the merge-path kernel; on a CPU device (tests)
    through the plain merge."""

    name = "cuda"

    def __init__(self, device):
        self.device = resolve_device(device)

    def _count(self, count: torch.Tensor) -> int:
        # int(count) waits for the device: the `device` span's wall time
        # covers dispatch + device execution
        c = int(count)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return c

    def survivors_cached_device(self, device_runs, now, pidx, pmask,
                                bottommost, do_filter):
        """The engine hot path: merge cached DeviceRuns (newest first)
        without host packing or re-upload. -> (survivor index into the
        runs' real concat, on the device; count)."""
        w = max(r.w for r in device_runs)
        fn = _make_cached_fn(tuple(r.padded_len for r in device_runs),
                             tuple(r.w for r in device_runs), w)
        # a batch of one: views, no copies
        cached = [(r.cols[None], r.klen[None]) for r in device_runs]
        aux = [(r.expire[None], r.deleted[None], r.hash32[None])
               for r in device_runs]
        with _TRACE.span("device", records=sum(r.n for r in device_runs)):
            real_off = torch.tensor([_real_offsets(device_runs)],
                                    device=self.device)
            out_idx, counts = fn(cached, aux, real_off, now, pidx, pmask,
                                 bool(bottommost), bool(do_filter))
            return out_idx[0], self._count(counts[0])

    def prepare(self, packed: PackedRuns) -> DevicePacked:
        with _TRACE.span("h2d", records=sum(packed.lens)) as sp:
            prep = self._prepare(packed)
            sp["bytes"] = sum(sum(t.numel() * t.element_size() for t in rc)
                              for rc in prep.run_cols)
            return prep

    def _prepare(self, packed: PackedRuns) -> DevicePacked:
        padded_lens = tuple(_pow2ceil(n, _MIN_BUCKET) for n in packed.lens)
        run_cols, aux = [], []
        dev = self.device
        for i, p in enumerate(padded_lens):
            n = packed.lens[i]
            arrays = list(packed.cols[i])
            if packed.has_rank:
                arrays.append(packed.rank[i])
            kcols = np.full((len(arrays), p), _U32_MAX, dtype=np.int64)
            for j, a in enumerate(arrays):
                kcols[j, :n] = a
            gidx = np.full(p, -1, dtype=np.int64)
            gidx[:n] = packed.gidx[i]
            run_cols.append((torch.from_numpy(kcols).to(dev),
                             torch.from_numpy(_u32_pad(packed.klen[i], p))
                             .to(dev),
                             torch.from_numpy(gidx).to(dev)))
            ex, de, hs = packed.run_aux[i]
            aux.append((torch.from_numpy(_zpad(ex, p, np.int64)).to(dev),
                        torch.from_numpy(_zpad(de, p, np.bool_)).to(dev),
                        torch.from_numpy(_zpad(hs, p, np.int64)).to(dev)))
        return DevicePacked(tuple(run_cols), tuple(aux), padded_lens,
                            packed.w, packed.has_rank)

    def survivors_device(self, packed, now, pidx, pmask, bottommost,
                         do_filter):
        """-> (device survivor index, count)."""
        prep = packed if isinstance(packed, DevicePacked) \
            else self.prepare(packed)
        nk = prep.w + (1 if prep.has_rank else 0) + 1
        # a batch of one: views, no copies
        run_cols = [tuple(t[None] for t in rc) for rc in prep.run_cols]
        aux = [tuple(t[None] for t in ax) for ax in prep.aux]
        with _TRACE.span("device", records=sum(prep.padded_lens)):
            out_idx, counts = _pipeline_body(
                run_cols, aux, prep.padded_lens, nk, now, pidx, pmask,
                bool(bottommost), bool(do_filter))
            return out_idx[0], self._count(counts[0])


def _checked_survivors(dev_idx: torch.Tensor, count: int, n: int):
    """Download the first `count` survivor indices, range-checked: a
    device pipeline defect must be loud, never a silently wrapped -1 or
    an out-of-bounds gather."""
    idx = dev_idx[:count].cpu().numpy()
    if count and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(
            "survivor index outside concat rows: device pipeline bug "
            f"(min {int(idx.min())}, max {int(idx.max())}, n {n})")
    return idx


def gather_device_survivors(concat: KVBlock, dev_idx, count: int) -> KVBlock:
    """Materialize concat.gather(survivors) from the device index."""
    if count == 0:
        return KVBlock.empty()
    with _TRACE.span("gather", records=count):
        return concat.gather(_checked_survivors(dev_idx, count, concat.n))


def _cached_val_gather(device_runs, idx: torch.Tensor,
                       vl0: int) -> torch.Tensor:
    """Per-run masked value-row gather by real-concat survivor index: run
    i owns indices [offs[i], offs[i] + n_i), its first n_i val2d rows."""
    offs = _real_offsets(device_runs)
    out = torch.zeros((idx.shape[0], vl0), dtype=torch.uint8,
                      device=idx.device)
    for r, off in zip(device_runs, offs):
        local = idx - off
        ok = (local >= 0) & (local < r.n)
        rows = r.val2d[local.clamp(0, r.n - 1)]
        out = torch.where(ok[:, None], rows, out)
    return out


def materialize_cached_survivors(concat: KVBlock, device_runs, dev_idx,
                                 count: int) -> KVBlock:
    """Compaction output with the value rows gathered ON THE DEVICE per
    run and downloaded as one block; keys and aux gather on the host,
    both by the real-concat survivor index. Preconditions (checked by the
    caller): every run has val2d with one shared vl0, and concat has the
    uniform layout matching it."""
    if count == 0:
        return KVBlock.empty()
    kl0, vl0 = concat.uniform_layout()
    with _TRACE.span("gather", records=count,
                     nbytes=count * (kl0 + vl0)):
        out_v = _cached_val_gather(device_runs, dev_idx[:count],
                                   vl0).cpu().numpy()
        idx = _checked_survivors(dev_idx, count, concat.n)
        keys, expire, hash32, deleted = native.gather_keys_uniform(
            concat.key_arena, kl0, concat.expire_ts, concat.hash32,
            concat.deleted, idx)
        return KVBlock(
            keys, np.arange(count, dtype=np.int64) * kl0,
            np.full(count, kl0, np.int32),
            out_v.reshape(-1), np.arange(count, dtype=np.int64) * vl0,
            np.full(count, vl0, np.int32), expire, hash32, deleted)


def gather_keys_uniform_plain(concat: KVBlock, kl0: int, idx) -> tuple:
    """native.gather_keys_uniform's numpy twin over a uniform block: four
    fancy-index sweeps. -> (keys, expire, hash32, deleted) of rows idx."""
    return (concat.key_arena.reshape(concat.n, kl0)[idx].reshape(-1),
            concat.expire_ts[idx], concat.hash32[idx], concat.deleted[idx])


def get_backend(name: str, device=None):
    if name == "cpu":
        return CpuBackend()
    if name == "cuda":
        return CudaBackend(device)
    raise ValueError(f"unknown compaction backend {name!r}")


def compact_blocks(blocks, opts: CompactOptions,
                   device_runs=None) -> CompactResult:
    """Merge K runs (newest first) into one sorted, deduped, filtered block.

    blocks[0] is the newest run, blocks[-1] the oldest: a version in a
    newer run shadows the same key in an older one.

    device_runs: optional parallel list of cached DeviceRuns (entries may
    be None). When the backend is cuda and EVERY non-empty run has one,
    the merge consumes the resident columns directly: no host packing, no
    re-upload. A device failure raises; nothing falls back to the cpu
    backend.

    A cuda merge of sorted runs with more than opts.max_device_records
    records goes blockwise (_compact_blockwise): disjoint key ranges
    compact one after another, each within the budget."""
    if device_runs is not None:
        device_runs = [d for b, d in zip(blocks, device_runs) if b.n]
    runs = [b for b in blocks if b.n]
    if not runs:
        return CompactResult(KVBlock.empty(), _stats(0, 0))
    # bigger than the device budget: dedup and every filter are per key,
    # so disjoint key ranges compact independently and their outputs
    # concatenate into exactly the whole merge's. Sorted runs only: the
    # range cuts binary-search each run (an unsorted input takes the
    # normal path, whose pack step sorts it)
    total_in = sum(b.n for b in runs)
    if (opts.backend != "cpu" and opts.runs_sorted
            and total_in > opts.max_device_records):
        return _compact_blockwise(runs, opts, total_in)
    # run priority travels in 8 bits of the packed (klen<<8 | prio) sort
    # column; wider merges pre-combine the newest runs (no filtering: only
    # the final merge may drop tombstones/expired) to stay within it
    while len(runs) > 255:
        head = compact_blocks(runs[:200], CompactOptions(
            now=opts.now, prefix_u32=opts.prefix_u32, backend=opts.backend,
            device=opts.device, filter=False, runs_sorted=opts.runs_sorted))
        runs = [head.block] + runs[200:]
        device_runs = None
    backend = get_backend(opts.backend, opts.device)
    now = opts.resolved_now()
    fargs = (now, opts.pidx, opts.partition_mask,
             bool(opts.bottommost), bool(opts.filter))
    concat = runs[0] if len(runs) == 1 else None

    def _concat():
        return concat if concat is not None else KVBlock.concat(runs)

    if backend.name == "cpu":
        packed = pack_runs(runs, opts, need_sbytes=True)
        survivors = backend.survivors(packed, *fargs)
        whole = _concat()
        with _TRACE.span("gather", records=len(survivors)):
            out = whole.gather(survivors)
    elif (device_runs is not None and len(device_runs) == len(runs)
            and all(d is not None for d in device_runs)):
        whole = _concat()
        vl0s = {d.vl0 for d in device_runs} \
            if all(d.val2d is not None for d in device_runs) else set()
        uni = whole.uniform_layout() if len(vl0s) == 1 else None
        dev_idx, count = backend.survivors_cached_device(device_runs, *fargs)
        if uni is not None and uni[1] == next(iter(vl0s)):
            out = materialize_cached_survivors(whole, device_runs, dev_idx,
                                               count)
        else:
            out = gather_device_survivors(whole, dev_idx, count)
    else:
        packed = pack_runs(runs, opts, need_sbytes=False)
        dev_idx, count = backend.survivors_device(packed, *fargs)
        out = gather_device_survivors(_concat(), dev_idx, count)
    out = apply_post_filters(out, opts, now)
    # stats count RAW input rows (pre any pack-time intra-run dedup)
    return CompactResult(out, _stats(sum(b.n for b in runs), out.n))


def apply_post_filters(out: KVBlock, opts: CompactOptions,
                       now: int) -> KVBlock:
    """Host-side post passes of every merge entry point (single,
    blockwise, batched): the user-specified compaction rules, then the
    table default_ttl rewrite, in the reference's order (its TTL filter
    runs the user ops first)."""
    if opts.filter and opts.user_ops:
        from ..engine.compaction_rules import apply_operations

        drop, _ = apply_operations(out, opts.user_ops, now)
        if drop.any():
            out = out.gather(np.nonzero(~drop)[0])
    if opts.filter and opts.default_ttl > 0:
        _apply_default_ttl(out, now + opts.default_ttl)
    return out


def _slice_block(b: KVBlock, lo: int, hi: int) -> KVBlock:
    """Zero-copy row slice. Each arena is cut, as a view, to the span its
    rows' bytes occupy, and their offsets rebased onto it: a range's
    concat and gather then copy that range's bytes, not every run's whole
    arena."""
    def cut(arena, off, length):
        off, length = off[lo:hi], length[lo:hi]
        if len(off) == 0:
            return arena[:0], off
        start = int(off.min())
        return arena[start: int((off + length).max())], off - start

    ka, ko = cut(b.key_arena, b.key_off, b.key_len)
    va, vo = cut(b.val_arena, b.val_off, b.val_len)
    return KVBlock(ka, ko, b.key_len[lo:hi], va, vo, b.val_len[lo:hi],
                   b.expire_ts[lo:hi], b.hash32[lo:hi], b.deleted[lo:hi])


def _compact_blockwise(runs, opts: CompactOptions,
                       total_in: int) -> CompactResult:
    """Range-decomposed compaction for merges bigger than the device
    budget: boundary keys from the largest run's quantiles cut EVERY run
    into aligned disjoint key ranges; each range merges, dedups and
    filters on its own and the outputs concatenate in key order. `now` is
    pinned once, so every range filters against the same clock.

    With PEGASUS_COMPACT_PIPELINE_DEPTH > 1 (default 2) the ranges run
    double-buffered (_compact_blockwise_pipelined); at depth 1 one after
    another through compact_blocks."""
    opts = replace(opts, now=opts.resolved_now())
    n_ranges = max(2, -(-total_in // opts.max_device_records))
    pivot = max(runs, key=lambda b: b.n)
    boundaries = []
    for j in range(1, n_ranges):
        k = pivot.key(min(pivot.n - 1, j * pivot.n // n_ranges))
        if not boundaries or k > boundaries[-1]:
            boundaries.append(k)
    cuts = [[0] * len(runs)]
    for k in boundaries:
        cuts.append([b.lower_bound(k) for b in runs])
    cuts.append([b.n for b in runs])
    # long keys take pack_runs' suffix-rank path, which concatenates its
    # inputs: zero-copy slices would drag the full shared arenas into
    # every range (n_ranges x the memory, on the bounded-memory path), so
    # such slices are compacted down to their own rows first
    long_keys = max(int(b.key_len.max()) for b in runs) > 4 * opts.prefix_u32
    jobs = []  # (non-empty range runs, range total, direct)
    for lo_cut, hi_cut in zip(cuts, cuts[1:]):
        range_runs = [_slice_block(b, lo, hi)
                      for b, lo, hi in zip(runs, lo_cut, hi_cut)]
        if long_keys:
            range_runs = [rb.gather(np.arange(rb.n, dtype=np.int64))
                          for rb in range_runs]
        range_runs = [rb for rb in range_runs if rb.n]
        range_total = sum(rb.n for rb in range_runs)
        if range_total == 0:
            continue
        # direct ranges re-enter compact_blocks whole instead of the split
        # pack/device/gather stages: non-shrinking (degenerate) ranges,
        # ranges still over budget (skewed keys: recursive blockwise) and
        # >255-run merges (the pre-combine path)
        direct = (range_total >= total_in
                  or range_total > opts.max_device_records
                  or len(range_runs) > 255)
        jobs.append((range_runs, range_total, direct))
    if len(jobs) > 1 and pipeline_depth() > 1:
        return _compact_blockwise_pipelined(jobs, opts, total_in)
    out_blocks = []
    for range_runs, range_total, _ in jobs:
        res = compact_blocks(range_runs,
                             _range_opts(opts, range_total, total_in))
        if res.block.n:
            out_blocks.append(res.block)
    return _concat_ranges(out_blocks, total_in)


def _range_opts(opts: CompactOptions, range_total: int,
                total_in: int) -> CompactOptions:
    """Per-range CompactOptions: a range that cannot shrink (one key
    repeated across the whole input) merges directly with a raised budget
    instead of recursing forever."""
    if range_total >= total_in:
        return replace(opts, max_device_records=range_total + 1)
    return opts


def _concat_ranges(out_blocks, total_in: int) -> CompactResult:
    out = (KVBlock.concat(out_blocks) if len(out_blocks) != 1
           else out_blocks[0])
    return CompactResult(out, _stats(total_in, out.n))


class _SideStream:
    """Device work of a pipeline worker on a CUDA stream of its own, so it
    overlaps the calling thread's kernels (on the default stream it would
    serialise with them). The consumer waits on the work's event before
    it reads the tensors, and marks them used on its own stream, so the
    caching allocator does not hand their memory out again while its
    kernels still read them. On a CPU device both steps are no-ops.

    The work may read DeviceRun columns, whose uploads were queued on the
    default stream (a pageable copy can return before its DMA ends), so
    the side stream first waits for what the default stream holds. That
    may include the dispatch in flight: milliseconds of device work beside
    the host stages the pipeline overlaps."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def run(self, fn, *args):
        """-> (fn(*args), event to wait on, or None)."""
        if self.stream is None:
            return fn(*args), None
        self.stream.wait_stream(torch.cuda.default_stream(self.device))
        with torch.cuda.stream(self.stream):
            out = fn(*args)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return out, ev

    def adopt(self, tensors, ev) -> None:
        """Make the calling thread's stream wait for `ev` and own
        `tensors`."""
        if ev is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in tensors:
            t.record_stream(cur)


def _compact_blockwise_pipelined(jobs, opts: CompactOptions,
                                 total_in: int) -> CompactResult:
    """Double-buffered range loop: range i+1 packs and uploads on a host
    worker (on a side stream) and range i-1 gathers and post-filters on
    another while range i runs its device merge. opts.now is pinned. A
    failure in any stage drains the workers and raises."""
    now = opts.now
    fargs = (now, opts.pidx, opts.partition_mask,
             bool(opts.bottommost), bool(opts.filter))
    backend = get_backend(opts.backend, opts.device)
    side = _SideStream(backend.device)

    def _prefetch(job):
        range_runs, _, direct = job
        if direct:
            return None
        packed = pack_runs(range_runs, opts, need_sbytes=False)
        return side.run(backend.prepare, packed)  # h2d on the worker

    def _dispatch(i, pre):
        range_runs, range_total, direct = jobs[i]
        if direct:
            return compact_blocks(
                range_runs, _range_opts(opts, range_total, total_in)).block
        prep, ev = pre
        side.adopt([t for group in prep.run_cols + prep.aux for t in group],
                   ev)
        return backend.survivors_device(prep, *fargs)

    def _finish(i, disp):
        range_runs, _, direct = jobs[i]
        if direct:
            return disp
        dev_idx, count = disp
        concat = (range_runs[0] if len(range_runs) == 1
                  else KVBlock.concat(range_runs))
        out = gather_device_survivors(concat, dev_idx, count)
        return apply_post_filters(out, opts, now)

    blocks = CompactPipeline().map(jobs, _prefetch, _dispatch, _finish)
    return _concat_ranges([b for b in blocks if b.n], total_in)


def sort_block(block: KVBlock, opts: CompactOptions = None) -> KVBlock:
    """Flush path: sort one run by key, newest-wins dedup, no filtering
    (a flush writes every live memtable record; the TTL filter runs at
    compaction only)."""
    opts = opts or CompactOptions()
    flush_opts = CompactOptions(
        now=opts.now, prefix_u32=opts.prefix_u32, backend=opts.backend,
        device=opts.device, filter=False, runs_sorted=False)
    return compact_blocks([block], flush_opts).block


def _apply_default_ttl(block: KVBlock, new_expire: int) -> None:
    """Rewrite expire_ts=0 records to the table default TTL, in place.
    expire_ts sits at value offset 0 (v0/v1) or 1 (self-describing v2)."""
    targets = np.nonzero((block.expire_ts == 0) & ~block.deleted)[0]
    if len(targets) == 0:
        return
    off = block.val_off[targets]
    vlen = block.val_len[targets]
    has_hdr = vlen > 0
    first = np.where(has_hdr, block.val_arena[
        np.minimum(off, len(block.val_arena) - 1)], 0)
    hdr = (first & 0x80) != 0
    # the 4-byte BE field must fit inside THIS record's value bytes: a
    # shorter value is skipped, or the rewrite would scribble into the
    # neighboring record's bytes (or off the arena end)
    fits = vlen >= np.where(hdr, 5, 4)
    if not bool(fits.all()):
        targets, off, hdr = targets[fits], off[fits], hdr[fits]
        if len(targets) == 0:
            return
    off = off + np.where(hdr, 1, 0)
    be = np.array(
        [(new_expire >> 24) & 0xFF, (new_expire >> 16) & 0xFF,
         (new_expire >> 8) & 0xFF, new_expire & 0xFF],
        dtype=np.uint8,
    )
    for j in range(4):
        block.val_arena[off + j] = be[j]
    block.expire_ts[targets] = np.uint32(new_expire)


def _stats(n_in: int, n_out: int) -> dict:
    return {"input_records": n_in, "output_records": n_out,
            "dropped": n_in - n_out}
