"""ctypes bindings of the port's host loops (csrc/hostops.cpp).

The library builds with g++ at first use (ops/_build.py, into
<repo>/.torch_ext/) and loads once per process. A failed build raises to
the caller that needed it; no binding falls back to numpy. The numpy
twins that tests hold these to sit beside their call sites, each named
`*_plain`.

The C side does unchecked pointer arithmetic, so every binding checks
what it is given first: an index outside [0, n), a slice outside its
arena or a row count past int32 where the C side uses int32 raises
ValueError before the call.

CALLS counts each binding's calls into the library, exported as the
perf counters host.<function>.calls, so a serving process can be
scraped for them.
"""

import ctypes
import threading

import numpy as np

from ..runtime.perf_counters import counters

_LOCK = threading.Lock()
_LIB = None

FUNCTIONS = ("crc64_batch", "crc64_update", "gather_arena", "pack_prefixes",
             "gather_block_uniform", "gather_keys_uniform", "merge_counts")
CALLS = dict.fromkeys(FUNCTIONS, 0)
_CALLS_LOCK = threading.Lock()
for _name in FUNCTIONS:
    counters.gauge(f"host.{_name}.calls",
                   lambda _name=_name: CALLS[_name])


def _lib():
    global _LIB
    lib = _LIB
    if lib is None:
        with _LOCK:
            if _LIB is None:
                from ..ops import _build

                lib = _build.load("hostops")
                _bind(lib)
                _LIB = lib
            lib = _LIB
    return lib


def _call(name: str):
    """The library's function behind binding `name`, counted."""
    with _CALLS_LOCK:
        CALLS[name] += 1
    return getattr(_lib(), name)


def _bind(lib) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    boolp = np.ctypeslib.ndpointer(np.bool_, flags="C")
    i64 = ctypes.c_int64
    lib.crc64_batch.argtypes = [u8p, i64p, i64p, i64, u64p]
    lib.crc64_update.argtypes = [u8p, i64p, i64p, i64, u64p, u64p]
    lib.gather_arena.argtypes = [u8p, i64p, i32p, i64p, i64, u8p, i64p]
    lib.pack_prefixes.argtypes = [u8p, i64p, i32p, i64, ctypes.c_int32,
                                  u32p]
    lib.gather_block_uniform.argtypes = [
        u8p, i64, u8p, i64, u32p, u32p, boolp, i32p, i64, u8p, u8p, u32p,
        u32p, boolp]
    lib.gather_keys_uniform.argtypes = [
        u8p, i64, u32p, u32p, boolp, i32p, i64, u8p, u32p, u32p, boolp]
    lib.merge_counts.argtypes = [u8p, i64, u8p, i64, i64, ctypes.c_int32,
                                 i64p]
    for fn in (lib.crc64_batch, lib.crc64_update, lib.gather_arena,
               lib.pack_prefixes, lib.gather_block_uniform,
               lib.gather_keys_uniform, lib.merge_counts):
        fn.restype = None


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8).reshape(-1)


def _check_index(idx: np.ndarray, n: int, what: str) -> None:
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"{what}: index outside [0, {n}) (min "
                         f"{int(idx.min())}, max {int(idx.max())})")


def _check_slices(total: int, off: np.ndarray, length: np.ndarray,
                  what: str) -> None:
    """Every slice [off, off + length) inside an arena of `total` bytes."""
    if len(off) and (int(off.min()) < 0 or int(length.min()) < 0
                     or int((off + length).max()) > total):
        raise ValueError(f"{what}: a slice lies outside the {total}-byte "
                         "arena")


def _slices(arena, offsets, lengths, what: str):
    arena = _u8(arena)
    off = np.ascontiguousarray(offsets, np.int64)
    ln = np.ascontiguousarray(lengths, np.int64)
    if off.shape != ln.shape:
        raise ValueError(f"{what}: {len(off)} offsets, {len(ln)} lengths")
    _check_slices(len(arena), off, ln, what)
    return arena, off, ln


def crc64_batch(arena, offsets, lengths) -> np.ndarray:
    """uint64[n]: crc64 of each slice of a uint8 arena."""
    arena, off, ln = _slices(arena, offsets, lengths, "crc64_batch")
    out = np.empty(len(off), np.uint64)
    if len(off):
        _call("crc64_batch")(arena, off, ln, len(off), out)
    return out


def crc64_update(crc, arena, offsets, lengths) -> np.ndarray:
    """Continue n CRC registers (before the final xor) over one slice
    each. -> the new registers (uint64[n])."""
    arena, off, ln = _slices(arena, offsets, lengths, "crc64_update")
    reg = np.ascontiguousarray(crc, np.uint64)
    if reg.shape != off.shape:
        raise ValueError(f"crc64_update: {len(reg)} registers, {len(off)} "
                         "slices")
    out = np.empty(len(off), np.uint64)
    if len(off):
        _call("crc64_update")(arena, off, ln, len(off), reg, out)
    return out


def gather_arena(arena, off, len32, idx) -> tuple:
    """-> (out arena, out offsets, out lengths) of the slices idx of
    (arena, off, len32), compacted in idx order."""
    arena = _u8(arena)
    off = np.ascontiguousarray(off, np.int64)
    len32 = np.ascontiguousarray(len32, np.int32)
    idx = np.ascontiguousarray(idx, np.int64)
    _check_index(idx, len(off), "gather_arena")
    sel_len = len32[idx]
    _check_slices(len(arena), off[idx], sel_len, "gather_arena")
    out = np.empty(int(sel_len.sum(dtype=np.int64)), np.uint8)
    out_off = np.empty(len(idx), np.int64)
    if len(idx):
        _call("gather_arena")(arena, off, len32, idx, len(idx), out, out_off)
    return out, out_off, sel_len


def pack_prefixes(arena, off, len32, w: int) -> np.ndarray:
    """-> uint32[n, w]: each key's first 4*w bytes as big-endian lanes,
    zero padded. The array is the transpose of the C side's column-major
    [w, n] output, so `.T` and `[:, j]` are contiguous."""
    arena = _u8(arena)
    off = np.ascontiguousarray(off, np.int64)
    len32 = np.ascontiguousarray(len32, np.int32)
    n = len(off)
    if len(len32) != n:
        raise ValueError(f"pack_prefixes: {n} offsets, {len(len32)} lengths")
    _check_slices(len(arena), off,
                  np.minimum(len32.astype(np.int64), 4 * w), "pack_prefixes")
    out = np.empty((w, n), np.uint32)
    if n:
        _call("pack_prefixes")(arena, off, len32, n, w, out.reshape(-1))
    return out.T


def _uniform_index(idx, n_rows: int, what: str) -> np.ndarray:
    if n_rows >= 1 << 31:
        raise ValueError(f"{what}: {n_rows} rows exceed the int32 index")
    idx = np.ascontiguousarray(idx, np.int64)
    _check_index(idx, n_rows, what)
    return idx.astype(np.int32)


def _uniform_arena(arena, width: int, n_rows: int, what: str) -> np.ndarray:
    arena = _u8(arena)
    if width <= 0 or len(arena) != n_rows * width:
        raise ValueError(f"{what}: arena of {len(arena)} bytes is not "
                         f"{n_rows} rows of {width}")
    return arena


def _aux(expire, hash32, deleted, n_rows: int, what: str) -> tuple:
    cols = (np.ascontiguousarray(expire, np.uint32),
            np.ascontiguousarray(hash32, np.uint32),
            np.ascontiguousarray(deleted, np.bool_))
    if any(len(c) != n_rows for c in cols):
        raise ValueError(f"{what}: aux columns are not {n_rows} rows")
    return cols


def gather_block_uniform(key_arena, klen: int, val_arena, vlen: int,
                         expire, hash32, deleted, idx) -> tuple:
    """One pass over the survivor index of a uniform-width block (every
    key klen bytes, every value vlen). -> (keys uint8[m * klen], values
    uint8[m * vlen], expire, hash32, deleted) of rows idx."""
    n_rows = len(expire)
    what = "gather_block_uniform"
    keys = _uniform_arena(key_arena, klen, n_rows, what)
    vals = _uniform_arena(val_arena, vlen, n_rows, what)
    ex, hs, de = _aux(expire, hash32, deleted, n_rows, what)
    idx = _uniform_index(idx, n_rows, what)
    m = len(idx)
    out = (np.empty(m * klen, np.uint8), np.empty(m * vlen, np.uint8),
           np.empty(m, np.uint32), np.empty(m, np.uint32),
           np.empty(m, np.bool_))
    if m:
        _call("gather_block_uniform")(keys, klen, vals, vlen, ex, hs, de, idx,
                                    m, *out)
    return out


def gather_keys_uniform(key_arena, klen: int, expire, hash32, deleted,
                        idx) -> tuple:
    """gather_block_uniform without the values. -> (keys uint8[m *
    klen], expire, hash32, deleted) of rows idx."""
    n_rows = len(expire)
    what = "gather_keys_uniform"
    keys = _uniform_arena(key_arena, klen, n_rows, what)
    ex, hs, de = _aux(expire, hash32, deleted, n_rows, what)
    idx = _uniform_index(idx, n_rows, what)
    m = len(idx)
    out = (np.empty(m * klen, np.uint8), np.empty(m, np.uint32),
           np.empty(m, np.uint32), np.empty(m, np.bool_))
    if m:
        _call("gather_keys_uniform")(keys, klen, ex, hs, de, idx, m, *out)
    return out


def merge_counts(a, b, side: str) -> np.ndarray:
    """int64[len(a)]: for each item of a, the count of items of b below
    it (side "left") or at most it (side "right"): np.searchsorted(b, a,
    side) for two ascending fixed-width byte-string arrays ('S' dtype of
    one width), in one pass over both."""
    if side not in ("left", "right"):
        raise ValueError(f"merge_counts: side {side!r}")
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if a.dtype != b.dtype or a.dtype.kind != "S":
        raise ValueError(f"merge_counts: dtypes {a.dtype} and {b.dtype}")
    out = np.empty(len(a), np.int64)
    if len(a):
        _call("merge_counts")(a.view(np.uint8).reshape(-1), len(a),
                            b.view(np.uint8).reshape(-1), len(b),
                            a.dtype.itemsize, 1 if side == "right" else 0,
                            out)
    return out
