"""The chunk grid of chunked transfers.

Port of pegasus_tpu/replication/learn.py's `chunk_waves`, the one grid
under the offload plane's ship and fetch waves (the learn plane itself
comes with the serving chain).
"""


def chunk_waves(total: int, chunk: int, wave_bytes: int = 8 << 20):
    """Yield bounded waves of (offset, length) descriptors covering a
    `total`-byte block: each wave's in-flight byte volume stays under
    `wave_bytes`, and a zero-byte block still yields its single
    empty-chunk descriptor."""
    offs = list(range(0, total, chunk)) or [0]
    per = max(1, wave_bytes // chunk)
    for i in range(0, len(offs), per):
        yield [(off, min(chunk, max(0, total - off)))
               for off in offs[i:i + per]]
