"""SST ("sorted string table") file format: columnar, device-loadable.

The same on-disk format as the JAX package, so either package opens the
other's engine directories. An SST is a serialized KVBlock:

    magic "PGTS1\\n" | u32 header_len | header json | sections (raw bytes)

The header carries section offsets/dtypes/shapes and crc32s, engine
metadata (level, last flushed decree), min/max key, record count and the
hashkey bloom filter.
"""

import json
import mmap
import os
import struct
import zlib

import numpy as np

from .block import KVBlock
from ..runtime.fail_points import inject
from ..runtime.tracing import COMPACT_TRACER

MAGIC = b"PGTS1\n"


class CorruptionError(ValueError):
    """Typed on-disk corruption: bad magic, truncated file, unparseable
    header, or a section whose crc32 no longer matches what write_sst
    recorded."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"{path}: {detail}")
        self.path = path
        self.detail = detail


_COLUMNS = [
    ("key_arena", np.uint8),
    ("key_off", np.int64),
    ("key_len", np.int32),
    ("val_arena", np.uint8),
    ("val_off", np.int64),
    ("val_len", np.int32),
    ("expire_ts", np.uint32),
    ("hash32", np.uint32),
    ("deleted", np.bool_),
]

_BLOOM_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)


def _bloom_build(hash32: np.ndarray) -> tuple:
    """Bloom filter over the per-record hashkey hash (one probe set per
    hash_key, shared by all its sort_keys). ~10 bits per distinct hash,
    k=5; returns (bits bytes, log2_m)."""
    uniq = np.unique(hash32)
    m = 64
    while m < len(uniq) * 10:
        m <<= 1
    log2m = m.bit_length() - 1
    bits = np.zeros(m // 8, dtype=np.uint8)
    h = uniq.astype(np.uint64)
    for salt in _BLOOM_SALTS:
        pos = ((h * np.uint64(salt)) & np.uint64(0xFFFFFFFF)) \
            >> np.uint64(32 - log2m)
        np.bitwise_or.at(bits, (pos >> np.uint64(3)).astype(np.int64),
                         (np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8)))
    return bits.tobytes(), log2m


def write_sst(path: str, block: KVBlock, meta: dict = None,
              compression: str = "none", bloom: tuple = None) -> dict:
    """Write atomically (tmp + fsync + rename). Returns the header dict.
    compression="zlib" deflates each section; readers detect it from the
    header. bloom=(hex, log2m) reuses the bloom SSTable.from_block already
    built for this exact block. The `engine.sst_write` fail point fires
    before any byte is written."""
    nbytes = block.key_bytes_total + block.val_bytes_total
    with COMPACT_TRACER.span("sst_write", records=block.n, nbytes=nbytes):
        inject("engine.sst_write")
        return _write_sst_impl(path, block, meta, compression, bloom)


def _bloom_hex(block: KVBlock) -> tuple:
    """(bloom hex, log2m) of a block's hashkey bloom; ("", 0) when empty."""
    if not block.n:
        return "", 0
    bits, log2m = _bloom_build(block.hash32)
    return bits.hex(), log2m


def _write_sst_impl(path: str, block: KVBlock, meta: dict,
                    compression: str, bloom: tuple = None) -> dict:
    sections = {}
    payload = []
    offset = 0
    for name, dtype in _COLUMNS:
        arr = np.ascontiguousarray(getattr(block, name), dtype=dtype)
        raw = arr.tobytes()
        stored = zlib.compress(raw, 1) if compression == "zlib" else raw
        sections[name] = {"offset": offset, "nbytes": len(stored),
                          "raw_nbytes": len(raw),
                          "dtype": np.dtype(dtype).str,
                          "shape": list(arr.shape),
                          "compression": compression,
                          "crc32": zlib.crc32(stored) & 0xFFFFFFFF}
        payload.append(stored)
        offset += len(stored)
    bloom_hex, bloom_log2m = bloom if bloom is not None else _bloom_hex(block)
    header = {
        "sections": sections,
        "meta": dict(meta or {}),
        "n": block.n,
        "min_key": block.key(0).hex() if block.n else None,
        "max_key": block.key(block.n - 1).hex() if block.n else None,
        "data_bytes": block.key_bytes_total + block.val_bytes_total,
        "bloom": bloom_hex,
        "bloom_log2m": bloom_log2m,
    }
    hdr = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for raw in payload:
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return header


def _read_header_open(f, path: str) -> dict:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise CorruptionError(path, f"bad SST magic {magic!r}")
    raw_len = f.read(4)
    if len(raw_len) < 4:
        raise CorruptionError(path, "truncated before header length")
    (hlen,) = struct.unpack("<I", raw_len)
    raw_hdr = f.read(hlen)
    if len(raw_hdr) < hlen:
        raise CorruptionError(
            path, f"truncated header ({len(raw_hdr)}/{hlen} bytes)")
    try:
        return json.loads(raw_hdr)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptionError(path, f"unparseable header: {e}") from e


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        return _read_header_open(f, path)


def _read_section(f, path: str, base: int, name: str, sec: dict) -> bytes:
    """One stored section, crc-checked when the header carries a crc32."""
    f.seek(base + sec["offset"])
    return _checked_section(path, name, sec, f.read(sec["nbytes"]))


def _checked_section(path: str, name: str, sec: dict, stored):
    """A section's stored bytes (as read, maybe short) -> its bytes, after
    the length and crc32 checks, decompressed when stored as zlib."""
    if len(stored) < sec["nbytes"]:
        raise CorruptionError(
            path, f"section {name} truncated "
                  f"({len(stored)}/{sec['nbytes']} bytes)")
    want = sec.get("crc32")
    if want is not None and (zlib.crc32(stored) & 0xFFFFFFFF) != want:
        raise CorruptionError(
            path, f"section {name} crc32 mismatch "
                  f"(stored {want:#010x}, "
                  f"computed {zlib.crc32(stored) & 0xFFFFFFFF:#010x})")
    if sec.get("compression", "none") == "zlib":
        try:
            stored = zlib.decompress(stored)
        except zlib.error as e:
            raise CorruptionError(
                path, f"section {name} undecompressable: {e}") from e
    return stored


def read_sst(path: str) -> tuple:
    """-> (KVBlock, header dict), over one mmap of the file: each
    uncompressed section is a read-only np.frombuffer view of the
    mapping (no read, no copy, and the page cache's pages are shared by
    every process that opens the file); a zlib section decompresses into
    fresh bytes.

    Lifetime: each view's .base chain holds the memoryview, which holds
    the mmap, which keeps the mapping; a mapped file's data stays valid
    after its path is unlinked (a compaction removes its inputs while
    readers may still hold their blocks). So a block read here stays
    readable as long as any of its arrays is referenced. A write into a
    view raises: no port code writes into a block it did not gather
    (the in-place rewrites of compaction rules and the default TTL touch
    only gathered output blocks)."""
    with open(path, "rb") as f:
        header = _read_header_open(f, path)
        base = f.tell()
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError) as e:  # empty or unmappable file
            raise CorruptionError(path, f"unmappable: {e}") from e
    mv = memoryview(mm)
    cols = {}
    for name, _ in _COLUMNS:
        try:
            sec = header["sections"][name]
        except (KeyError, TypeError) as e:
            raise CorruptionError(
                path, f"header missing section {name}") from e
        off = base + sec["offset"]
        # a negative offset would slice from the mapping's end
        stored = _checked_section(path, name, sec,
                                  mv[off:off + sec["nbytes"]]
                                  if off >= base else b"")
        try:
            cols[name] = np.frombuffer(
                stored, dtype=np.dtype(sec["dtype"])).reshape(sec["shape"])
        except (ValueError, TypeError) as e:
            raise CorruptionError(
                path, f"section {name} unmaterializable: {e}") from e
    return KVBlock(**cols), header


def verify_sst(path: str) -> int:
    """Full-file integrity pass (scrub): magic, header parse, and every
    section's length + crc32, without materializing a KVBlock. -> the
    bytes read; raises CorruptionError on any finding."""
    with open(path, "rb") as f:
        header = _read_header_open(f, path)
        base = f.tell()
        scanned = base
        sections = header.get("sections")
        if not isinstance(sections, dict):
            raise CorruptionError(path, "header missing sections")
        for name, _ in _COLUMNS:
            sec = sections.get(name)
            if not isinstance(sec, dict):
                raise CorruptionError(path, f"header missing section {name}")
            scanned += len(_read_section(f, path, base, name, sec))
    return scanned


class SSTable:
    """An open SST: header always resident, block lazily loaded.

    Point lookups binary-search the key arena; min/max keys and the
    hashkey bloom let the level walk skip files without touching data.
    A file may also hold a device-resident run (device_run): its packed
    key columns, uploaded once, which compactions merge and reads probe.
    """

    def __init__(self, path: str):
        self.path = path
        self.header = read_header(path)
        self._init_runtime_state()

    def _init_runtime_state(self) -> None:
        self._block = None
        # False while a deferred install has not landed the file yet
        self._on_disk = True
        self._device_run = None
        self._device_uncacheable = False
        self._values_uncacheable = False
        # set once a merge consumed this file: its run stops serving, and
        # a late async prime must not pin device memory for it
        self._device_retired = False
        # engine-side prime coordination: _prime_inflight keeps an async
        # prime and an inline caller from uploading one file twice;
        # _device_budgeted records whether _device_run's bytes count
        # against the engine's budget (a release subtracts only then);
        # _prime_error keeps an async prime's device failure for the next
        # caller that needs this run; _prime_failed stays set until a
        # prime succeeds, so reads re-prime it and never walk the host
        self._prime_inflight = False
        self._device_budgeted = False
        self._prime_error = None
        self._prime_failed = False
        self._bloom = None
        if self.header.get("bloom"):
            self._bloom = bytes.fromhex(self.header["bloom"])
        self._bloom_log2m = int(self.header.get("bloom_log2m", 0))

    @classmethod
    def from_block(cls, path: str, block: KVBlock,
                   meta: dict = None) -> "SSTable":
        """In-memory SSTable over a not-yet-written block, for the
        engine's deferred installs: the header is built from the block so
        reads, blooms and level bookkeeping work at once, while write_sst
        lands the file on a pool worker. _on_disk stays False until it
        does; `sections` is empty because the cached block makes the disk
        read path unreachable (write_sst writes the real header)."""
        self = cls.__new__(cls)
        self.path = path
        bloom_hex, bloom_log2m = _bloom_hex(block)
        self.header = {
            "sections": {},
            "meta": dict(meta or {}),
            "n": block.n,
            "min_key": block.key(0).hex() if block.n else None,
            "max_key": block.key(block.n - 1).hex() if block.n else None,
            "data_bytes": block.key_bytes_total + block.val_bytes_total,
            "bloom": bloom_hex,
            "bloom_log2m": bloom_log2m,
        }
        self._init_runtime_state()
        self._block = block
        self._on_disk = False
        return self

    @property
    def n(self) -> int:
        return self.header["n"]

    @property
    def data_bytes(self) -> int:
        db = self.header.get("data_bytes")
        if db is None:  # pre-data_bytes header: derive from the sections
            db = (self.header["sections"]["key_arena"]["nbytes"]
                  + self.header["sections"]["val_arena"]["nbytes"])
        return int(db)

    def maybe_contains_hash(self, h32) -> bool:
        """Hashkey bloom probe; False = definitely absent (no disk read).
        Plain integers on the bloom's bytes: the probe runs per key per
        file on the read path, where numpy scalars cost ~10x."""
        if self._bloom is None:
            return self.n > 0
        h, shift, bloom = int(h32), 32 - self._bloom_log2m, self._bloom
        for salt in _BLOOM_SALTS:
            pos = ((h * salt) & 0xFFFFFFFF) >> shift
            if not (bloom[pos >> 3] >> (pos & 7)) & 1:
                return False
        return True

    @property
    def min_key(self):
        mk = self.header["min_key"]
        return bytes.fromhex(mk) if mk else None

    @property
    def max_key(self):
        mk = self.header["max_key"]
        return bytes.fromhex(mk) if mk else None

    @property
    def meta(self) -> dict:
        return self.header["meta"]

    def block(self) -> KVBlock:
        if self._block is None:
            self._block, _ = read_sst(self.path)
        return self._block

    def maybe_contains(self, key: bytes) -> bool:
        return self.n > 0 and self.min_key <= key <= self.max_key

    def find(self, key: bytes) -> int:
        """Index of `key` or -1; binary search over the sorted key column."""
        if not self.maybe_contains(key):
            return -1
        b = self.block()
        lo, hi = 0, b.n - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            k = b.key(mid)
            if k < key:
                lo = mid + 1
            elif k > key:
                hi = mid - 1
            else:
                return mid
        return -1

    def lower_bound(self, key: bytes) -> int:
        """First index with block.key(i) >= key (n if none)."""
        return self.block().lower_bound(key)

    @property
    def device_index(self):
        """The device-resident read index of this file, or None when the
        file is not device-servable: the DeviceRun primed at flush or
        compaction time, carrying the fence index its prime built. A
        retired run (consumed by a merge) stops serving."""
        dr = self._device_run
        if dr is None or self._device_retired or dr.fence is None:
            return None
        return dr

    def device_run(self, prefix_u32: int, device, with_values: bool = False):
        """Pack + upload this file's sort columns to `device` once and pin
        them for the file's lifetime. None when the run is uncacheable
        (keys beyond the prefix window need per-merge suffix ranks).
        with_values additionally pins uniform-layout value rows."""
        needs_pack = self._device_run is None or (
            with_values and self._device_run.val2d is None
            and not self._values_uncacheable)
        if needs_pack and not self._device_uncacheable:
            from ..ops.compact import pack_run_device

            self._device_run = pack_run_device(self.block(), prefix_u32,
                                               with_values=with_values,
                                               device=device)
            if self._device_run is None:
                self._device_uncacheable = True
            elif with_values and self._device_run.val2d is None:
                self._values_uncacheable = True
        return self._device_run
