"""CRC-64 used for partition hashing.

CRC-64/XZ parameters (reflected poly 0xC96C5795D7870F42, init/xorout
0xFFFFFFFFFFFFFFFF), the same function the JAX package uses for
partition routing and split-era ownership checks, so both packages route
every key identically.

The batched form is vectorized numpy: the port carries no native
extension, and the numpy path is byte-identical to the slice-by-8 C
kernel the JAX package may use.
"""

import numpy as np

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
_MASK = 0xFFFFFFFFFFFFFFFF


def crc64(data: bytes, initial: int = 0) -> int:
    """crc64_calc(data, len, initial) equivalent."""
    crc = (initial ^ _MASK) & _MASK
    tbl = _TABLE_LIST
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return (crc ^ _MASK) & _MASK


def crc64_batch(arena: np.ndarray, offsets: np.ndarray,
                lengths: np.ndarray) -> np.ndarray:
    """Hash many byte strings packed in one uint8 arena.

    arena: uint8[total]; offsets/lengths: int[n]. Returns uint64[n].
    Vectorized across records byte-position-at-a-time: the loop runs
    max(lengths) times, each step over every record still live. Hash keys
    are short, so this is ~100x a per-record Python loop."""
    n = len(offsets)
    crc = np.full(n, _MASK, dtype=np.uint64)
    if n == 0:
        return crc
    maxlen = int(lengths.max())
    offsets = offsets.astype(np.int64)
    lengths = lengths.astype(np.int64)
    for i in range(maxlen):
        live = lengths > i
        if not live.any():
            break
        idx = offsets[live] + i
        b = arena[idx].astype(np.uint64)
        c = crc[live]
        crc[live] = _TABLE[((c ^ b) & np.uint64(0xFF)).astype(np.int64)] \
            ^ (c >> np.uint64(8))
    return crc ^ np.uint64(_MASK)
