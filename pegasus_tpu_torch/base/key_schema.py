"""Pegasus key codec, byte-identical to the reference format.

stored key = [hash_key_len (uint16 big-endian)] [hash_key bytes] [sort_key bytes]

Keys sort byte-lexicographically, so all records of one hash_key are
contiguous and ordered by sort_key.
"""

import struct

from .crc64 import crc64

UINT16_MAX = 0xFFFF


def generate_key(hash_key: bytes, sort_key: bytes = b"") -> bytes:
    if len(hash_key) >= UINT16_MAX:
        raise ValueError("hash key length must be less than UINT16_MAX")
    return struct.pack(">H", len(hash_key)) + hash_key + sort_key


def generate_next_bytes(hash_key: bytes, sort_key: bytes = None) -> bytes:
    """Adjacent successor key for exclusive range stops: strip trailing
    0xFF bytes, then increment the last remaining byte. With sort_key None
    this is the successor of the hash_key prefix (the stop of a whole
    hash_key scan)."""
    buf = bytearray(generate_key(hash_key,
                                 sort_key if sort_key is not None else b""))
    p = len(buf) - 1
    while buf[p] == 0xFF:
        p -= 1
    buf[p] += 1
    return bytes(buf[: p + 1])


def key_hash(key: bytes) -> int:
    """Partition hash from a stored key: crc64 of the hash_key, or of the
    sort_key when hash_key_len == 0."""
    if len(key) < 2:
        raise ValueError("key length must be no less than 2")
    (hash_key_len,) = struct.unpack_from(">H", key, 0)
    if hash_key_len > 0:
        if len(key) < 2 + hash_key_len:
            raise ValueError(
                "key length must be no less than (2 + hash_key_len)")
        return crc64(key[2: 2 + hash_key_len])
    return crc64(key[2:])


def expire_ts_from_ttl(ttl_seconds: int) -> int:
    """TTL seconds -> absolute expire timestamp (2016-based epoch); 0 =
    none."""
    from .utils import epoch_now

    return epoch_now() + int(ttl_seconds) if ttl_seconds > 0 else 0


def restore_key(key: bytes) -> tuple:
    """(hash_key, sort_key) from a stored key."""
    if len(key) < 2:
        raise ValueError("key length must be no less than 2")
    (hash_key_len,) = struct.unpack_from(">H", key, 0)
    if len(key) < 2 + hash_key_len:
        raise ValueError(
            "key length must be no less than (2 + hash_key_len)")
    return key[2: 2 + hash_key_len], key[2 + hash_key_len:]


def check_key_hash(key: bytes, pidx: int, partition_version: int) -> bool:
    """True iff this key is served by partition `pidx` under
    `partition_version` (a 2^k-1 mask during and after a split)."""
    return (key_hash(key) & partition_version) == pidx
