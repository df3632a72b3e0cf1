"""Memtable: the mutable in-memory run.

A plain dict keyed by stored key: writes to one partition are serialized
(one decree at a time), so newest-write-wins within the dict is exactly
last-sequence-wins inside one memtable. Sorting is deferred to flush,
where it runs as one batched device pass.
"""

from .block import KVBlock


class Memtable:
    def __init__(self):
        self._data = {}  # key -> (value_bytes, expire_ts, deleted)
        self._bytes = 0
        self.last_decree = 0  # highest decree contained; stamped per write

    def __len__(self):
        return len(self._data)

    @property
    def approximate_bytes(self) -> int:
        return self._bytes

    def put(self, key: bytes, value: bytes, expire_ts: int = 0):
        old = self._data.get(key)
        if old is not None:
            self._bytes -= len(key) + len(old[0])
        self._data[key] = (value, expire_ts, False)
        self._bytes += len(key) + len(value)

    def delete(self, key: bytes):
        old = self._data.get(key)
        if old is not None:
            self._bytes -= len(key) + len(old[0])
        self._data[key] = (b"", 0, True)
        self._bytes += len(key)

    def put_batch(self, items):
        """Insert many (key, value, expire_ts) records in one call."""
        data = self._data
        delta = 0
        for key, value, expire_ts in items:
            old = data.get(key)
            if old is not None:
                delta -= len(key) + len(old[0])
            data[key] = (value, expire_ts, False)
            delta += len(key) + len(value)
        self._bytes += delta

    def delete_batch(self, keys):
        """Tombstone many keys in one call (put_batch's twin)."""
        data = self._data
        delta = 0
        for key in keys:
            old = data.get(key)
            if old is not None:
                delta -= len(key) + len(old[0])
            data[key] = (b"", 0, True)
            delta += len(key)
        self._bytes += delta

    def get(self, key: bytes):
        """-> (value, expire_ts, deleted) or None if the key was never seen."""
        return self._data.get(key)

    def to_block(self) -> KVBlock:
        """Unsorted columnar snapshot; the flush path sorts it."""
        return KVBlock.from_records(
            (k, v, e, d) for k, (v, e, d) in self._data.items())

    def items(self):
        return self._data.items()
