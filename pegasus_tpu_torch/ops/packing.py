"""Host-side packing: variable-length keys -> fixed-width device sort keys.

A stored key's first `4*W` bytes are packed big-endian into W uint32
lanes, so unsigned lexicographic order over the lanes == byte order over
the prefix (shorter keys zero-pad).

The full device sort key is (prefix_lanes..., suffix_rank, key_len):

  - suffix_rank breaks ties between *long* keys (> window) sharing a
    prefix window: collision groups are found on the host, full keys
    compared within the group, and a dense rank assigned. Equal full keys
    share a rank, which dedup relies on.
  - key_len breaks the remaining ties exactly: two short keys with equal
    padded windows differ only in trailing 0x00 bytes (shorter is
    byte-smaller), and a short key whose window matches long keys is
    their strict byte prefix.

So (window, rank, len) equality <=> full-key equality, and its order is
full byte order.

The module also holds the run wire: a KVBlock as one byte string for
shipping whole runs between processes (replication/compact_offload.py).
"""

import json
import struct

import numpy as np

from .. import native

DEFAULT_PREFIX_U32 = 8  # 32-byte prefix window

# ---------------------------------------------------------------- run wire
# A KVBlock flattened to one deterministic byte string: magic, u32 LE
# header length, a json header (n, and per column its dtype, shape and
# byte count), then the raw column buffers in _RUN_COLUMNS order. The
# JAX package writes the same bytes for the same block, and their md5 is
# the offload service's content address, so every byte here (magic, key
# order and separators of the json, column order, dtypes) is wire
# contract. A transfer form, not a storage format: no bloom, no meta.

_RUN_MAGIC = b"PGRN1\n"
_RUN_COLUMNS = (
    ("key_arena", np.uint8), ("key_off", np.int64), ("key_len", np.int32),
    ("val_arena", np.uint8), ("val_off", np.int64), ("val_len", np.int32),
    ("expire_ts", np.uint32), ("hash32", np.uint32), ("deleted", np.bool_),
)


def pack_run_bytes(block) -> bytes:
    """One KVBlock -> its wire bytes (the same block gives the same
    bytes)."""
    cols = {}
    parts = []
    for name, dtype in _RUN_COLUMNS:
        arr = np.ascontiguousarray(getattr(block, name), dtype=dtype)
        raw = arr.tobytes()
        cols[name] = {"dtype": np.dtype(dtype).str, "shape": list(arr.shape),
                      "nbytes": len(raw)}
        parts.append(raw)
    hdr = json.dumps({"n": int(block.n), "cols": cols},
                     sort_keys=True).encode()
    return b"".join([_RUN_MAGIC, struct.pack("<I", len(hdr)), hdr] + parts)


def unpack_run_bytes(data: bytes):
    """Wire bytes -> KVBlock (inverse of pack_run_bytes). Raises
    ValueError on bytes that are not a whole run."""
    from ..engine.block import KVBlock

    if data[:len(_RUN_MAGIC)] != _RUN_MAGIC:
        raise ValueError("bad run wire magic")
    base = len(_RUN_MAGIC) + 4
    if len(data) < base:
        raise ValueError("truncated run wire header")
    (hlen,) = struct.unpack_from("<I", data, len(_RUN_MAGIC))
    try:
        cols = json.loads(data[base:base + hlen])["cols"]
        secs = [(name, cols[name]["nbytes"], np.dtype(cols[name]["dtype"]),
                 cols[name]["shape"]) for name, _ in _RUN_COLUMNS]
    except (UnicodeDecodeError, KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad run wire header: {e!r}") from None
    off = base + hlen
    kwargs = {}
    for name, nbytes, dtype, shape in secs:
        raw = data[off:off + nbytes]
        if len(raw) != nbytes:
            raise ValueError(f"truncated run wire column {name}")
        kwargs[name] = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        off += nbytes
    return KVBlock(**kwargs)


# rows per chunk of pack_key_prefixes: bounds its int64 [rows, 4*W] index
# temporary to ~64 MiB at the widest window (a 2.5M-row run would
# otherwise need ~0.6 GB for it)
_PACK_CHUNK_BYTES = 64 << 20


def pack_sbytes(prefix_cols, klen, rank=None):
    """Fixed-width big-endian byte string per record: (prefix cols..,
    [rank,] klen) -> numpy 'S' array whose memcmp order equals the device
    sort order (run priority excluded)."""
    cols = list(prefix_cols) + ([rank] if rank is not None else []) + [klen]
    n = len(klen)
    packed = np.zeros((n, len(cols)), dtype=">u4")
    for i, c in enumerate(cols):
        packed[:, i] = c
    return packed.view(f"S{4 * len(cols)}").ravel()


def pack_key_prefixes(key_arena, key_off, key_len,
                      width_u32: int = DEFAULT_PREFIX_U32):
    """-> uint32[n, width_u32], big-endian packed, zero-padded, from the
    C loop (native.pack_prefixes): the transpose of a column-major
    [width_u32, n] array, so a column `[:, j]` and `.T` are contiguous."""
    return native.pack_prefixes(key_arena, key_off, key_len, width_u32)


def pack_key_prefixes_plain(key_arena, key_off, key_len,
                            width_u32: int = DEFAULT_PREFIX_U32):
    """pack_key_prefixes' numpy twin (row-major)."""
    n = len(key_off)
    w_bytes = width_u32 * 4
    out = np.zeros((n, width_u32), np.uint32)
    if n == 0 or len(key_arena) == 0:  # no rows, or only empty keys
        return out
    pos = np.arange(w_bytes, dtype=np.int64)
    last = len(key_arena) - 1
    chunk = max(1, _PACK_CHUNK_BYTES // (8 * w_bytes))
    for s in range(0, n, chunk):
        off = key_off[s: s + chunk]
        ln = key_len[s: s + chunk]
        idx = off[:, None] + pos[None, :]
        valid = pos[None, :] < ln[:, None]
        b = np.where(valid, key_arena[np.minimum(idx, last)], 0) \
            .astype(np.uint32).reshape(len(off), width_u32, 4)
        out[s: s + chunk] = ((b[..., 0] << 24) | (b[..., 1] << 16)
                             | (b[..., 2] << 8) | b[..., 3])
    return out


def compute_suffix_ranks(block, width_u32: int = DEFAULT_PREFIX_U32):
    """-> uint32[n]: dense order rank among records sharing a prefix window.

    0 for records with a unique prefix (the loop below only touches
    collision groups). Equal full keys map to the same rank."""
    n = block.n
    ranks = np.zeros(n, np.uint32)
    over = np.nonzero(block.key_len > width_u32 * 4)[0]
    if len(over) == 0:
        return ranks
    prefixes = pack_key_prefixes(block.key_arena, block.key_off,
                                 block.key_len, width_u32)
    groups = {}
    for i in over:
        groups.setdefault(prefixes[i].tobytes(), []).append(int(i))
    for g in groups.values():
        if len(g) < 2:
            continue
        keyed = sorted((block.key(i), i) for i in g)
        rank = 0
        prev = None
        for k, i in keyed:
            if prev is not None and k != prev:
                rank += 1
            ranks[i] = rank
            prev = k
    return ranks
