"""The port's host loops (csrc/hostops.cpp, pegasus_tpu_torch.native)
against their numpy twins and the JAX package's native layer.

Each binding runs the C library, built here with g++, on seeded arenas
with the edge cases the engine meets (empty keys, an all-empty arena,
keys shorter and longer than the 4 * w prefix window, 0xFF bytes, no
rows, variable widths) and must be byte-equal to its port twin
(`*_plain`), to pegasus_tpu.native's function and to the reference's
numpy form. Then the slice end to end: a cpu-backend port engine's
digest against the reference engine's, and the mmap SST read against the
reference's read_sst.
"""

import os

import numpy as np
import pytest

import pegasus_tpu.native as ref_native
from pegasus_tpu.base.crc64 import crc64_batch_numpy as ref_crc64_numpy
from pegasus_tpu.engine import block as ref_block
from pegasus_tpu.engine import sstable as ref_sstable
from pegasus_tpu.engine.block import KVBlock as RefBlock
from pegasus_tpu.engine.db import EngineOptions as RefOptions
from pegasus_tpu.engine.db import LsmEngine as RefEngine
from pegasus_tpu.engine.db import WriteBatch as RefBatch
from pegasus_tpu.base.key_schema import generate_key
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu_torch import native
from pegasus_tpu_torch.base.crc64 import (MASK, crc64_batch,
                                          crc64_batch_plain, crc64_update,
                                          crc64_update_plain)
from pegasus_tpu_torch.engine import block as port_block
from pegasus_tpu_torch.engine import sstable
from pegasus_tpu_torch.engine.block import KVBlock
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine, WriteBatch
from pegasus_tpu_torch.ops import _build
from pegasus_tpu_torch.ops.compact import (gather_keys_uniform_plain,
                                           merge_counts_plain)
from pegasus_tpu_torch.ops.packing import (pack_key_prefixes,
                                           pack_key_prefixes_plain,
                                           pack_sbytes)

CASES = ("random", "empty_keys", "all_empty", "ff", "no_rows", "long",
         "uniform", "window_edges")


def _arena(case: str, seed: int = 0):
    """-> (uint8 arena, int64 offsets, int32 lengths) of one edge case."""
    rng = np.random.default_rng(seed)
    if case == "random":
        lens = rng.integers(0, 48, 500)
    elif case == "empty_keys":
        lens = np.where(rng.random(400) < 0.5, 0, rng.integers(1, 12, 400))
    elif case == "all_empty":
        lens = np.zeros(300, np.int64)
    elif case == "ff":
        lens = rng.integers(0, 40, 300)
    elif case == "no_rows":
        lens = np.zeros(0, np.int64)
    elif case == "long":
        lens = rng.integers(900, 2100, 40)
    elif case == "uniform":
        lens = np.full(400, 26)
    else:  # "window_edges": every length around 4 * w for w in 1..10
        lens = np.repeat(np.arange(0, 44), 5)
    total = int(lens.sum())
    arena = (np.full(total, 0xFF, np.uint8) if case == "ff"
             else rng.integers(0, 256, total, dtype=np.uint8))
    off = np.cumsum(lens) - lens
    return arena, off.astype(np.int64), lens.astype(np.int32)


def _index(n: int, seed: int = 1) -> np.ndarray:
    """Rows in a shuffled order, with repeats; empty for n = 0."""
    rng = np.random.default_rng(seed)
    if n == 0:
        return np.zeros(0, np.int64)
    return np.concatenate([rng.permutation(n), rng.integers(0, n, n // 3)])


@pytest.fixture
def ref_numpy(monkeypatch):
    """The reference's numpy forms: its native layer reported absent."""
    monkeypatch.setattr(ref_native, "available", lambda: False)


@pytest.mark.parametrize("case", CASES)
def test_crc64_batch_equals_twin_and_reference(case):
    arena, off, lens = _arena(case)
    got = crc64_batch(arena, off, lens)
    assert got.dtype == np.uint64 and got.shape == (len(off),)
    for want in (crc64_batch_plain(arena, off, lens),
                 ref_native.crc64_batch(arena, off, lens),
                 ref_crc64_numpy(arena, off, lens.astype(np.int64))):
        assert got.tobytes() == np.asarray(want, np.uint64).tobytes()


@pytest.mark.parametrize("case", CASES)
def test_crc64_update_equals_twin_from_own_registers(case):
    arena, off, lens = _arena(case)
    regs = np.random.default_rng(5).integers(0, 1 << 63, len(off),
                                             dtype=np.uint64)
    got = crc64_update(regs, arena, off, lens)
    assert got.tobytes() == crc64_update_plain(regs, arena, off,
                                               lens).tobytes()


@pytest.mark.parametrize("cuts", [(0,), (1,), (4, 9), (3, 8, 8, 30)])
def test_a_record_hashed_in_parts_equals_it_hashed_whole(cuts):
    arena, off, lens = _arena("random", seed=7)
    reg = np.full(len(off), MASK, np.uint64)
    start = np.zeros(len(off), np.int64)
    for c in list(cuts) + [1 << 30]:
        end = np.minimum(lens, c)
        step = np.maximum(end - start, 0)
        reg = crc64_update(reg, arena, off + start, step)
        start = start + step
    whole = ref_native.crc64_batch(arena, off, lens)
    assert (reg ^ np.uint64(MASK)).tobytes() == whole.tobytes()


@pytest.mark.parametrize("w", [1, 3, 7, 8, 10])
@pytest.mark.parametrize("case", CASES)
def test_pack_prefixes_equals_twin_and_reference(case, w):
    arena, off, lens = _arena(case)
    got = pack_key_prefixes(arena, off, lens, w)
    assert got.shape == (len(off), w) and got.dtype == np.uint32
    assert got.T.flags.c_contiguous
    want = pack_key_prefixes_plain(arena, off, lens, w)
    ref = ref_native.pack_prefixes(arena, off, lens, w)
    assert np.array_equal(got, want) and np.array_equal(got, ref)
    assert np.ascontiguousarray(got).tobytes() == want.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_gather_arena_equals_twin_and_reference(case, ref_numpy):
    arena, off, lens = _arena(case)
    idx = _index(len(off))
    got = native.gather_arena(arena, off, lens, idx)
    twin = port_block._gather_arena_plain(arena, off, lens, idx)
    ref_out, ref_off = _ref_native_gather(arena, off, lens, idx)
    ref_np = ref_block._gather_arena(arena, off, lens, idx)
    for want in (twin, (ref_out, ref_off, lens[idx]), ref_np):
        assert got[0].tobytes() == np.asarray(want[0], np.uint8).tobytes()
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2]) and got[2].dtype == np.int32
    # the engine's gather takes the C loop for any non-uniform arena
    via = port_block._gather_arena(arena, off, lens, idx)
    assert all(np.array_equal(a, b) for a, b in zip(via, got))


def _ref_native_gather(arena, off, lens, idx):
    """pegasus_tpu.native.gather_arena with its library, whatever
    `available` says."""
    lib = ref_native._load()
    assert lib is not None, "the reference's hostops did not build"
    return ref_native.gather_arena(arena, off, lens, idx)


def _uniform_block(cls, n: int, kl: int = 26, vl: int = 20, seed: int = 3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, n * kl, dtype=np.uint8)
    keys[::17] = 0xFF
    vals = rng.integers(0, 256, n * vl, dtype=np.uint8)
    return cls(keys, np.arange(n, dtype=np.int64) * kl,
               np.full(n, kl, np.int32), vals,
               np.arange(n, dtype=np.int64) * vl, np.full(n, vl, np.int32),
               rng.integers(0, 1 << 32, n, dtype=np.uint32),
               rng.integers(0, 1 << 32, n, dtype=np.uint32),
               rng.random(n) < 0.2)


_FIELDS = ("key_arena", "key_off", "key_len", "val_arena", "val_off",
           "val_len", "expire_ts", "hash32", "deleted")


def _same_block(a, b) -> bool:
    return all(getattr(a, f).dtype == getattr(b, f).dtype
               and np.asarray(getattr(a, f)).tobytes()
               == np.asarray(getattr(b, f)).tobytes() for f in _FIELDS)


@pytest.mark.parametrize("n,count", [(0, 0), (50, 0), (50, 70),
                                     (40_000, port_block.FUSED_GATHER_MIN),
                                     (40_000, 50_000)])
def test_gather_block_uniform_equals_twin_and_reference(n, count):
    blk = _uniform_block(KVBlock, n)
    ref = _uniform_block(RefBlock, n)
    idx = np.random.default_rng(4).integers(0, max(n, 1), count)
    got = native.gather_block_uniform(blk.key_arena, 26, blk.val_arena, 20,
                                      blk.expire_ts, blk.hash32,
                                      blk.deleted, idx)
    twin = blk.gather_plain(idx)
    outs = (np.empty(count * 26, np.uint8), np.empty(count * 20, np.uint8),
            np.empty(count, np.uint32), np.empty(count, np.uint32),
            np.empty(count, np.bool_))
    if n:
        assert ref_native.gather_block_uniform(
            ref.key_arena, 26, ref.val_arena, 20, ref.expire_ts, ref.hash32,
            ref.deleted, idx.astype(np.int32), *outs)
    wants = [(twin.key_arena, twin.val_arena, twin.expire_ts, twin.hash32,
              twin.deleted)] + ([outs] if n else [])
    for want in wants:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # KVBlock.gather: fused at FUSED_GATHER_MIN rows and above, and equal
    # to its twin and to the reference's gather either way
    assert _same_block(blk.gather(idx), twin)
    assert _same_block(blk.gather(idx), ref.gather(idx))


@pytest.mark.parametrize("n,count", [(0, 0), (60, 90), (3000, 5000)])
def test_gather_keys_uniform_equals_twin_and_reference(n, count):
    blk = _uniform_block(KVBlock, n, kl=13, seed=9)
    idx = np.random.default_rng(6).integers(0, max(n, 1), count)
    got = native.gather_keys_uniform(blk.key_arena, 13, blk.expire_ts,
                                     blk.hash32, blk.deleted, idx)
    twin = gather_keys_uniform_plain(blk, 13, idx)
    outs = (np.empty(count * 13, np.uint8), np.empty(count, np.uint32),
            np.empty(count, np.uint32), np.empty(count, np.bool_))
    wants = [twin]
    if n:
        assert ref_native.gather_keys_uniform(
            blk.key_arena, 13, blk.expire_ts, blk.hash32, blk.deleted,
            idx.astype(np.int32), *outs)
        wants.append(outs)
    for want in wants:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _sorted_sbytes(rng, n: int, shared) -> np.ndarray:
    """A sorted unique run of packed sort keys (pack_sbytes: 3 prefix
    lanes with 0x00 and 0xFF bytes, klen), holding some of `shared`."""
    lanes = rng.choice(np.array([0, 0xFF, 0xFFFFFFFF, 0x00FF00FF, 7],
                                np.uint32), size=(n, 3))
    lanes[:, 2] = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    sb = pack_sbytes([lanes[:, j] for j in range(3)],
                     rng.integers(1, 13, n).astype(np.uint32))
    if len(shared):
        sb = np.concatenate([sb, rng.choice(shared, len(shared) // 2,
                                            replace=False)])
    return np.unique(sb)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("na,nb", [(0, 0), (0, 40), (40, 0), (1, 1),
                                   (300, 500), (2000, 70)])
def test_merge_counts_equals_searchsorted_and_reference(side, na, nb):
    rng = np.random.default_rng(na * 7 + nb)
    shared = _sorted_sbytes(rng, 60, [])
    a = _sorted_sbytes(rng, na, shared) if na else shared[:0]
    b = _sorted_sbytes(rng, nb, shared) if nb else shared[:0]
    got = native.merge_counts(a, b, side)
    assert got.dtype == np.int64 and got.shape == (len(a),)
    for want in (merge_counts_plain(a, b, side),
                 np.searchsorted(b, a, side=side),
                 ref_native.merge_counts(a, b, side)):
        assert np.array_equal(got, want)
    if na and nb:
        # equal keys across the runs, where the two sides differ
        assert np.isin(a, b).any()


@pytest.mark.parametrize("bad", [-1, "n"])
@pytest.mark.parametrize("fn", ["gather_arena", "gather_block_uniform",
                                "gather_keys_uniform"])
def test_an_index_outside_the_rows_raises(fn, bad):
    blk = _uniform_block(KVBlock, 40)
    idx = np.array([0, 5, blk.n if bad == "n" else bad, 3])
    call = {
        "gather_arena": lambda: native.gather_arena(
            blk.key_arena, blk.key_off, blk.key_len, idx),
        "gather_block_uniform": lambda: native.gather_block_uniform(
            blk.key_arena, 26, blk.val_arena, 20, blk.expire_ts,
            blk.hash32, blk.deleted, idx),
        "gather_keys_uniform": lambda: native.gather_keys_uniform(
            blk.key_arena, 26, blk.expire_ts, blk.hash32, blk.deleted, idx),
    }[fn]
    with pytest.raises(ValueError, match="index outside"):
        call()


@pytest.mark.parametrize("fn", ["crc64_batch", "pack_prefixes"])
def test_a_slice_outside_the_arena_raises(fn):
    arena, off, lens = _arena("random")
    off = off.copy()
    off[-1] = len(arena)
    lens = lens.copy()
    lens[-1] = 3
    with pytest.raises(ValueError, match="outside"):
        if fn == "crc64_batch":
            native.crc64_batch(arena, off, lens)
        else:
            native.pack_prefixes(arena, off, lens, 2)


def test_a_failed_build_raises_to_the_first_caller(tmp_path, monkeypatch):
    src = open(os.path.join(_build.CSRC, "hostops.cpp")).read()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hostops.cpp").write_text(
        src.replace("extern \"C\" {", "extern \"C\" { int broken = ;", 1))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "ext"))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError) as err:
        native.crc64_batch(np.zeros(4, np.uint8), [0], [4])
    msg = str(err.value)
    assert "g++ failed for hostops.cpp" in msg and "error" in msg
    assert "broken" in msg
    assert native._LIB is None
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "ext"))


# ------------------------------------------------------- the slice whole


def _fill(eng, batch_cls, flush, seed: int = 11):
    rng = np.random.default_rng(seed)
    decree = 0
    for round_ in range(4):
        wb = batch_cls()
        for _ in range(150):
            i = int(rng.integers(0, 500))
            key = generate_key(b"h%03d" % (i % 41), b"\xff" * (i % 3)
                               + b"s%05d" % i)
            if rng.random() < 0.1:
                wb.delete(key)
            else:
                exp = int(rng.choice([0, 0, 995, 1050]))
                wb.put(key, SCHEMAS[2].generate_value(
                    exp, 0, b"v%d" % i * (1 + i % 9)), exp)
        decree += 1
        eng.write_batch([(wb, decree)])
        flush(eng)


def test_cpu_engine_runs_the_c_loops_and_digests_as_the_reference(
        tmp_path):
    before = dict(native.CALLS)
    ref = RefEngine(str(tmp_path / "ref"), RefOptions(
        backend="cpu", memtable_bytes=1 << 30, l0_compaction_trigger=100))
    port = LsmEngine(str(tmp_path / "port"), EngineOptions(
        backend="cpu", device="cpu", memtable_bytes=1 << 30,
        l0_compaction_trigger=100))
    try:
        _fill(ref, RefBatch, lambda e: e.flush())
        _fill(port, WriteBatch, lambda e: e.flush())
        for eng in (ref, port):
            eng.manual_compact(now=1000)
        assert port.state_digest(now=1000) == ref.state_digest(now=1000)
        assert port.state_digest(now=1000, pmask=3) == \
            ref.state_digest(now=1000, pmask=3)
        keys = [generate_key(b"h%03d" % (i % 41), b"\xff" * (i % 3)
                             + b"s%05d" % i) for i in range(500)]
        assert [port.get(k, now=1000) for k in keys] == \
            [ref.get(k, now=1000) for k in keys]
        assert list(port.scan(now=1000)) == list(ref.scan(now=1000))
    finally:
        ref.close()
        port.close()
    assert native._LIB is not None
    calls = {k: native.CALLS[k] - before[k] for k in before}
    for name in ("crc64_batch", "crc64_update", "pack_prefixes",
                 "merge_counts", "gather_arena"):
        assert calls[name] > 0, (name, calls)


def _blocks(seed: int = 2):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(300):
        rows.append((generate_key(b"h%02d" % (i % 17), b"s%04d" % i),
                     bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                        dtype=np.uint8)),
                     int(rng.integers(0, 3)), i % 11 == 0))
    rows.sort()
    return RefBlock.from_records(rows), KVBlock.from_records(rows)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("compression", ["none", "zlib"])
def test_mmap_read_equals_the_reference_read(tmp_path, writer, compression):
    ref_blk, port_blk = _blocks()
    path = str(tmp_path / "x.sst")
    if writer == "reference":
        ref_sstable.write_sst(path, ref_blk, compression=compression)
    else:
        sstable.write_sst(path, port_blk, compression=compression)
    got, header = sstable.read_sst(path)
    want, want_header = ref_sstable.read_sst(path)
    assert header == want_header
    assert _same_block(got, want)
    if compression == "none":
        assert not got.key_arena.flags.writeable
        with pytest.raises(ValueError):
            got.expire_ts[0] = 1
    # a gather of a mapped block is an ordinary writable block
    out = got.gather(np.arange(got.n))
    assert out.val_arena.flags.writeable and _same_block(out, got)


def test_a_mapped_block_outlives_its_unlinked_file(tmp_path):
    _, blk = _blocks(seed=4)
    path = str(tmp_path / "y.sst")
    sstable.write_sst(path, blk)
    got, _ = sstable.read_sst(path)
    os.unlink(path)
    assert [got.key(i) for i in range(got.n)] == \
        [blk.key(i) for i in range(blk.n)]
    assert [got.value(i) for i in range(got.n)] == \
        [blk.value(i) for i in range(blk.n)]


@pytest.mark.parametrize("damage", ["flip", "truncate_header",
                                    "truncate_section"])
def test_a_damaged_file_raises_the_reference_corruption(tmp_path, damage):
    _, blk = _blocks(seed=5)
    path = str(tmp_path / "z.sst")
    sstable.write_sst(path, blk)
    data = bytearray(open(path, "rb").read())
    if damage == "flip":
        data[-1] ^= 0xFF
    elif damage == "truncate_header":
        data = data[:20]
    else:
        data = data[:-3]
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(sstable.CorruptionError) as got:
        sstable.read_sst(path)
    with pytest.raises(ref_sstable.CorruptionError) as want:
        ref_sstable.read_sst(path)
    assert got.value.detail == want.value.detail
