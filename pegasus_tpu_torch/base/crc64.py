"""CRC-64 used for partition hashing.

CRC-64/XZ parameters (reflected poly 0xC96C5795D7870F42, init/xorout
0xFFFFFFFFFFFFFFFF), the same function the JAX package uses for
partition routing and split-era ownership checks, so both packages route
every key identically.

The batched forms run the port's slice-by-8 C loop (csrc/hostops.cpp
through pegasus_tpu_torch.native): they are the cost of every state
digest (audits, learn and split proofs) and of partition hashing. The
vectorized numpy forms beside them, `crc64_batch_plain` and
`crc64_update_plain`, are the twins tests hold the C loop to.
"""

import numpy as np

# the batched forms, in C: crc64_batch(arena, offsets, lengths) -> the
# uint64 crc64 of each slice; crc64_update(registers, arena, offsets,
# lengths) continues n registers (before the final xor) over one slice
# each, so a record hashed in parts equals the record hashed whole
from ..native import crc64_batch, crc64_update  # noqa: F401

_POLY = 0xC96C5795D7870F42


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        crc = i
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ _POLY
            else:
                crc >>= 1
        table[i] = crc
    return table


_TABLE = _make_table()
_TABLE_LIST = _TABLE.tolist()  # python ints: faster in the scalar loop
MASK = 0xFFFFFFFFFFFFFFFF   # init and xorout


def crc64(data: bytes, initial: int = 0) -> int:
    """crc64_calc(data, len, initial) equivalent."""
    crc = (initial ^ MASK) & MASK
    tbl = _TABLE_LIST
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return (crc ^ MASK) & MASK


def crc64_batch_plain(arena: np.ndarray, offsets: np.ndarray,
                      lengths: np.ndarray) -> np.ndarray:
    """crc64_batch's numpy twin."""
    start = np.full(len(offsets), MASK, dtype=np.uint64)
    return crc64_update_plain(start, arena, offsets, lengths) \
        ^ np.uint64(MASK)


def crc64_update_plain(crc: np.ndarray, arena: np.ndarray,
                       offsets: np.ndarray,
                       lengths: np.ndarray) -> np.ndarray:
    """crc64_update's numpy twin.

    Vectorized across records byte-position-at-a-time. The records are
    taken longest first, so the records still live at byte i are a
    prefix; records up to _LONG bytes go in chunks, each gathered record
    by record (its bytes read in order) and transposed once, so that
    every byte step reads one contiguous row. Longer records take the
    gather-per-step loop."""
    n = len(offsets)
    if n == 0:
        return np.array(crc, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    order = np.argsort(-lengths, kind="stable")
    lens, offs = lengths[order], offsets[order]
    reg = np.asarray(crc, dtype=np.uint64)[order]
    n_long = int(np.count_nonzero(lens > _LONG))
    for i in range(int(lens[0]) if n_long else 0):
        k = n_long - int(np.searchsorted(lens[n_long - 1::-1], i,
                                         side="right"))
        if k == 0:
            break
        c = reg[:k]
        b = arena[offs[:k] + i].astype(np.uint64)
        reg[:k] = _TABLE[((c ^ b) & _FF).astype(np.intp)] ^ (c >> _EIGHT)
    last = max(len(arena) - 1, 0)
    lo = n_long
    while lo < n:
        width = int(lens[lo])
        if width == 0:
            break
        hi = min(n, lo + max(64, _CHUNK_BYTES // width))
        cl, c = lens[lo:hi], reg[lo:hi]
        rows = np.ascontiguousarray(arena[np.minimum(
            offs[lo:hi, None] + np.arange(width), last)].T)
        live = (hi - lo) - np.searchsorted(cl[::-1], np.arange(width),
                                           side="right")
        for i in range(width):
            k = int(live[i])
            ck = c[:k]
            c[:k] = _TABLE[((ck ^ rows[i, :k]) & _FF).astype(np.intp)] \
                ^ (ck >> _EIGHT)
        lo = hi
    out = np.empty(n, dtype=np.uint64)
    out[order] = reg
    return out


_FF = np.uint64(0xFF)
_EIGHT = np.uint64(8)
_LONG = 1024               # records longer than this take the per-step gather
_CHUNK_BYTES = 1 << 22     # bytes of one transposed chunk
