"""KVBlock: the columnar record batch the whole engine is built around.

A block of records in structure-of-arrays layout: byte arenas for
variable-length keys/values plus fixed-width numpy columns (expire_ts,
partition hash, tombstone flag) that stream to the device without
per-record host work. Flush sorts a block on the device; compaction
merges many.

Invariants:
  - keys are full stored keys (base.key_schema layout), so
    np-lexicographic byte order == engine key order.
  - hash32 is the low 32 bits of the key's partition hash.
  - `deleted` marks tombstones (the value arena entry is empty for them).

Every row layout produced here is byte-identical to the JAX package's
KVBlock. Gathers of arenas run the port's C loops (pegasus_tpu_torch.
native); their numpy twins (`_gather_arena_plain`, `KVBlock.gather_plain`)
are what tests hold them to.
"""

from dataclasses import dataclass

import numpy as np

from .. import native
from ..base.crc64 import crc64_batch

# a gather of at least this many rows from a uniform block takes the
# fused one-pass loop (native.gather_block_uniform)
FUSED_GATHER_MIN = 1 << 15


def _as_arena(chunks) -> tuple:
    """list[bytes] -> (uint8 arena, int64 offsets, int32 lengths)."""
    lengths = np.fromiter((len(c) for c in chunks), dtype=np.int32,
                          count=len(chunks))
    offsets = np.zeros(len(chunks), dtype=np.int64)
    if len(chunks):
        np.cumsum(lengths[:-1], out=offsets[1:])
    arena = (np.frombuffer(b"".join(chunks), dtype=np.uint8).copy()
             if chunks else np.zeros(0, np.uint8))
    return arena, offsets, lengths


def _gather_uniform_2d(arena, offsets, lengths, idx):
    """The gather of a uniform-length, row-contiguous arena as a 2D fancy
    index (one memcpy per row); None for any other arena."""
    n = len(lengths)
    if n and len(idx):
        l0 = int(lengths[0])
        if l0 > 0 and int(lengths.min()) == l0 == int(lengths.max()) \
                and len(arena) == n * l0 \
                and offsets[0] == 0 and int(offsets[-1]) == (n - 1) * l0:
            out = arena.reshape(n, l0)[idx].reshape(-1)
            new_off = np.arange(len(idx), dtype=np.int64) * l0
            return out, new_off, np.full(len(idx), l0, np.int32)
    return None


def _gather_arena(arena, offsets, lengths, idx):
    """Gather of variable-length slices: new compact arena for idx.
    Uniform-length row-contiguous arenas take a 2D fancy index; anything
    else the C loop (native.gather_arena)."""
    out = _gather_uniform_2d(arena, offsets, lengths, idx)
    if out is not None:
        return out
    return native.gather_arena(arena, offsets, lengths, idx)


def _gather_arena_plain(arena, offsets, lengths, idx):
    """_gather_arena's numpy twin: the 2D fancy index, else the
    repeat/cumsum construction."""
    out = _gather_uniform_2d(arena, offsets, lengths, idx)
    if out is not None:
        return out
    sel_off = offsets[idx]
    sel_len = lengths[idx].astype(np.int64)
    total = int(sel_len.sum())
    new_off = np.zeros(len(idx), dtype=np.int64)
    if len(idx):
        np.cumsum(sel_len[:-1], out=new_off[1:])
    if total == 0:
        return np.zeros(0, np.uint8), new_off, sel_len.astype(np.int32)
    starts = np.repeat(sel_off, sel_len)
    within = np.arange(total, dtype=np.int64) - np.repeat(new_off, sel_len)
    return arena[starts + within], new_off, sel_len.astype(np.int32)


@dataclass
class KVBlock:
    key_arena: np.ndarray  # uint8[total_key_bytes]
    key_off: np.ndarray    # int64[n]
    key_len: np.ndarray    # int32[n]
    val_arena: np.ndarray  # uint8[total_val_bytes]
    val_off: np.ndarray    # int64[n]
    val_len: np.ndarray    # int32[n]
    expire_ts: np.ndarray  # uint32[n]
    hash32: np.ndarray     # uint32[n]: low 32 bits of the key hash
    deleted: np.ndarray    # bool[n]

    @property
    def n(self) -> int:
        return len(self.key_off)

    @property
    def key_bytes_total(self) -> int:
        return int(self.key_len.sum())

    @property
    def val_bytes_total(self) -> int:
        return int(self.val_len.sum())

    def key(self, i: int) -> bytes:
        o, l = self.key_off[i], self.key_len[i]
        return self.key_arena[o: o + l].tobytes()

    def value(self, i: int) -> bytes:
        o, l = self.val_off[i], self.val_len[i]
        return self.val_arena[o: o + l].tobytes()

    @staticmethod
    def from_records(records) -> "KVBlock":
        """records: iterable of (key, value, expire_ts, deleted)."""
        records = list(records)
        ka, ko, kl = _as_arena([r[0] for r in records])
        va, vo, vl = _as_arena([r[1] for r in records])
        expire = np.fromiter((r[2] for r in records), dtype=np.uint32,
                             count=len(records))
        deleted = np.fromiter((bool(r[3]) for r in records), dtype=np.bool_,
                              count=len(records))
        hashes = _batch_key_hashes(ka, ko, kl)
        return KVBlock(ka, ko, kl, va, vo, vl, expire,
                       (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       deleted)

    def lower_bound(self, key: bytes) -> int:
        """First index with self.key(i) >= key (n if none); rows must be
        key-sorted (SSTs and merge outputs are)."""
        lo, hi = 0, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self.key(mid) < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def uniform_layout(self):
        """(key_len, val_len) when every record has the same key and value
        widths and both arenas are contiguous in row order; None otherwise.
        Offsets are monotonic in row order for every constructor here, so
        endpoints plus a midpoint decide contiguity."""
        n = self.n
        if not n:
            return None
        kl0 = int(self.key_len[0])
        vl0 = int(self.val_len[0])
        mid = n // 2
        if (kl0 > 0
                and int(self.key_len.min()) == kl0 == int(self.key_len.max())
                and vl0 > 0
                and int(self.val_len.min()) == vl0 == int(self.val_len.max())
                and len(self.key_arena) == n * kl0
                and len(self.val_arena) == n * vl0
                and self.key_off[0] == 0
                and int(self.key_off[-1]) == (n - 1) * kl0
                and int(self.key_off[mid]) == mid * kl0
                and self.val_off[0] == 0
                and int(self.val_off[-1]) == (n - 1) * vl0
                and int(self.val_off[mid]) == mid * vl0):
            return kl0, vl0
        return None

    def gather(self, idx) -> "KVBlock":
        """New block with rows idx (in that order); arenas compacted.
        A large gather from a uniform block moves keys, values and aux
        in one C pass over idx (native.gather_block_uniform); any other
        gathers each arena (_gather_arena) and fancy-indexes the aux."""
        idx = np.asarray(idx, dtype=np.int64)
        count = len(idx)
        uni = self.uniform_layout() \
            if count >= FUSED_GATHER_MIN and self.n < 1 << 31 else None
        if uni is not None:
            kl0, vl0 = uni
            ka, va, ex, hs, de = native.gather_block_uniform(
                self.key_arena, kl0, self.val_arena, vl0, self.expire_ts,
                self.hash32, self.deleted, idx)
            return KVBlock(
                ka, np.arange(count, dtype=np.int64) * kl0,
                np.full(count, kl0, np.int32),
                va, np.arange(count, dtype=np.int64) * vl0,
                np.full(count, vl0, np.int32), ex, hs, de)
        ka, ko, kl = _gather_arena(self.key_arena, self.key_off,
                                   self.key_len, idx)
        va, vo, vl = _gather_arena(self.val_arena, self.val_off,
                                   self.val_len, idx)
        return KVBlock(ka, ko, kl, va, vo, vl,
                       self.expire_ts[idx], self.hash32[idx],
                       self.deleted[idx])

    def gather_plain(self, idx) -> "KVBlock":
        """gather's numpy twin."""
        idx = np.asarray(idx, dtype=np.int64)
        ka, ko, kl = _gather_arena_plain(self.key_arena, self.key_off,
                                         self.key_len, idx)
        va, vo, vl = _gather_arena_plain(self.val_arena, self.val_off,
                                         self.val_len, idx)
        return KVBlock(ka, ko, kl, va, vo, vl,
                       self.expire_ts[idx], self.hash32[idx],
                       self.deleted[idx])

    @staticmethod
    def concat(blocks) -> "KVBlock":
        blocks = [b for b in blocks if b.n]
        if not blocks:
            return KVBlock.empty()
        k_shift = np.cumsum([0] + [len(b.key_arena) for b in blocks[:-1]])
        v_shift = np.cumsum([0] + [len(b.val_arena) for b in blocks[:-1]])
        return KVBlock(
            np.concatenate([b.key_arena for b in blocks]),
            np.concatenate([b.key_off + s for b, s in zip(blocks, k_shift)]),
            np.concatenate([b.key_len for b in blocks]),
            np.concatenate([b.val_arena for b in blocks]),
            np.concatenate([b.val_off + s for b, s in zip(blocks, v_shift)]),
            np.concatenate([b.val_len for b in blocks]),
            np.concatenate([b.expire_ts for b in blocks]),
            np.concatenate([b.hash32 for b in blocks]),
            np.concatenate([b.deleted for b in blocks]),
        )

    @staticmethod
    def empty() -> "KVBlock":
        z8, z64, z32 = (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                        np.zeros(0, np.int32))
        return KVBlock(z8, z64, z32, z8.copy(), z64.copy(), z32.copy(),
                       np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                       np.zeros(0, np.bool_))


def _batch_key_hashes(key_arena, key_off, key_len) -> np.ndarray:
    """Partition hash of every stored key in an arena, vectorized: crc64
    over the hash_key portion, or over the sort_key when
    hash_key_len == 0 (base.key_schema.key_hash)."""
    n = len(key_off)
    if n == 0:
        return np.zeros(0, np.uint64)
    hi = key_arena[key_off].astype(np.uint16)
    lo = key_arena[key_off + 1].astype(np.uint16)
    hklen = ((hi << 8) | lo).astype(np.int64)
    body_off = key_off + 2
    body_len = np.where(hklen > 0, hklen, key_len.astype(np.int64) - 2)
    return crc64_batch(key_arena, body_off, body_len)
