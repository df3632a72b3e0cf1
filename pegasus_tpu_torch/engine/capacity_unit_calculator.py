"""Capacity-unit accounting: per-op read/write units + byte counters.

The port's copy of pegasus_tpu/engine/capacity_unit_calculator.py, over
the port's counter registry (the same counter names).

Mirror of src/server/capacity_unit_calculator.{h,cpp}: each data op has
its own add_*_cu entry point that (a) adds ceil(bytes / {read,write}_
cu_size) units to the replica's CU counters (the billing/throttling
surface), (b) bumps a per-op bytes counter (get_bytes, multi_get_bytes,
scan_bytes, put_bytes, ...), and (c) feeds the hotkey collectors with the
reference's weight rules (capacity_unit_calculator.h:107-117): multi-ops
weigh by their kv count, scans don't capture, and read-modify-write ops
(incr / check_and_set / check_and_mutate) charge BOTH read and write CU
because they perform both a read and a write.
"""

from ..runtime.perf_counters import counters


class CapacityUnitCalculator:
    def __init__(self, app_id: int, pidx: int, read_cu_size: int = 4096,
                 write_cu_size: int = 4096, read_hotkey=None, write_hotkey=None):
        self.read_cu_size = read_cu_size
        self.write_cu_size = write_cu_size
        self._pfx = f"app.{app_id}.{pidx}."
        self._read_cu = counters.rate(self._pfx + "recent_read_cu")
        self._write_cu = counters.rate(self._pfx + "recent_write_cu")
        self.read_hotkey = read_hotkey
        self.write_hotkey = write_hotkey

    # ------------------------------------------------------------ internals

    def _units(self, nbytes: int, unit: int) -> int:
        return max(1, -(-max(nbytes, 1) // unit))

    def _charge_read(self, nbytes: int, hash_key=None, weight: int = 1):
        self._read_cu.add(self._units(nbytes, self.read_cu_size))
        if hash_key is not None and self.read_hotkey is not None:
            self.read_hotkey.capture(hash_key, weight=weight)

    def _charge_write(self, nbytes: int, hash_key=None, weight: int = 1):
        self._write_cu.add(self._units(nbytes, self.write_cu_size))
        if hash_key is not None and self.write_hotkey is not None:
            self.write_hotkey.capture(hash_key, weight=weight)

    def _bytes(self, op: str, nbytes: int):
        counters.rate(self._pfx + op + "_bytes").add(nbytes)

    # ------------------------------------------------------------ read ops

    def add_get_cu(self, hash_key: bytes, key: bytes, value: bytes) -> None:
        b = len(key) + len(value)
        self._bytes("get", b)
        self._charge_read(b, hash_key)

    def add_multi_get_cu(self, hash_key: bytes, kvs) -> None:
        b = sum(len(kv.key) + len(kv.value) for kv in kvs)
        self._bytes("multi_get", b)
        self._charge_read(b, hash_key, weight=max(1, len(kvs)))

    def add_scan_cu(self, kvs) -> None:
        # reference: scan charges read CU but captures no hotkey (:110)
        b = sum(len(kv.key) + len(kv.value) for kv in kvs)
        self._bytes("scan", b)
        self._charge_read(b)

    def add_sortkey_count_cu(self, hash_key: bytes) -> None:
        self._charge_read(1, hash_key)

    def add_ttl_cu(self, hash_key: bytes, key: bytes) -> None:
        self._charge_read(len(key), hash_key)

    # ----------------------------------------------------------- write ops

    def add_put_cu(self, hash_key: bytes, key: bytes, value: bytes) -> None:
        b = len(key) + len(value)
        self._bytes("put", b)
        self._charge_write(b, hash_key)

    def add_remove_cu(self, hash_key: bytes, key: bytes) -> None:
        self._charge_write(len(key), hash_key)

    def add_multi_put_cu(self, hash_key: bytes, kvs) -> None:
        b = len(hash_key) + sum(len(kv.key) + len(kv.value) for kv in kvs)
        self._bytes("multi_put", b)
        self._charge_write(b, hash_key, weight=max(1, len(kvs)))

    def add_multi_remove_cu(self, hash_key: bytes, sort_keys) -> None:
        b = len(hash_key) + sum(len(sk) for sk in sort_keys)
        self._charge_write(b, hash_key, weight=max(1, len(sort_keys)))

    # ------------------------------------------- read-modify-write ops

    def add_incr_cu(self, hash_key: bytes, key: bytes) -> None:
        # incr reads the old value then writes the new: both CU pools
        self._charge_read(len(key))
        self._charge_write(len(key), hash_key)

    def add_check_and_set_cu(self, hash_key: bytes, check_sort_key: bytes,
                             set_sort_key: bytes, value: bytes) -> None:
        b = len(hash_key) + len(check_sort_key) + len(set_sort_key) + len(value)
        self._bytes("check_and_set", b)
        self._charge_read(len(hash_key) + len(check_sort_key))
        self._charge_write(b, hash_key)

    def add_check_and_mutate_cu(self, hash_key: bytes, check_sort_key: bytes,
                                mutate_bytes: int, mutate_count: int) -> None:
        b = len(hash_key) + len(check_sort_key) + mutate_bytes
        self._bytes("check_and_mutate", b)
        self._charge_read(len(hash_key) + len(check_sort_key))
        self._charge_write(b, hash_key, weight=max(1, mutate_count))

