"""Bulk load: external-file ingestion through the engine's device merge.

Port of pegasus_tpu/engine/bulk_load.py: a provider directory holds
per-partition ingest sets; each replica ingests its partition's files
(the ingestion_files write). Ingest sets may be UNSORTED record files:
compact_blocks sorts each in its pack step and merges the k files with
k - 1 merges, on the card through the merge-path kernel.

Ingest file format: either a native SST (engine/sstable.py, ingested
as-is) or a "raw set" file, byte-identical to pegasus_tpu's:

    magic "PGRAW1\\n" then framed records
    [u16 hk_len][hash_key][u32 sk_len][sort_key][u32 v_len][value][u32 ttl]

(little-endian lengths). Provider layout (the bulk_load_provider_root):
    <root>/<app_name>/<partition_count>/<pidx>/*.sst|*.raw
    <root>/<app_name>/bulk_load_metadata (json: file list + sizes)

The raw-set reader and writer work on whole columns with numpy (the JAX
package walks records one by one in Python): a label per byte names the
field it belongs to, and each field moves as one masked copy. Both
packages read and write the same bytes.
"""

import json
import os
import struct

import numpy as np

from .block import KVBlock, _as_arena, _batch_key_hashes
from .sstable import MAGIC as SST_MAGIC, SSTable

RAW_MAGIC = b"PGRAW1\n"

_RUN_TO_SPECULATE = 8   # equal-length records seen before speculating
_FIRST_WINDOW = 64      # records checked by the first speculation step
_U16 = struct.Struct("<H").unpack_from
_U32 = struct.Struct("<I").unpack_from


def _rows_bytes(arena, off, length) -> np.ndarray:
    """The rows of an (arena, offsets, lengths) column back to back."""
    arena = np.asarray(arena, np.uint8)
    off = np.asarray(off, np.int64)
    lens = np.asarray(length, np.int64)
    total = int(lens.sum())
    if len(off) == 0 or (off[0] == 0 and np.array_equal(
            off[1:], off[:-1] + lens[:-1])):
        return arena[:total]   # already back to back in row order
    base = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=base[1:])
    return arena[np.repeat(off - base, lens)
                 + np.arange(total, dtype=np.int64)]


def _labels(*seg_lens) -> np.ndarray:
    """int8 label per byte of records laid out as consecutive segments:
    segment j of every record (seg_lens[j], an int or a per-record array)
    gets label j."""
    n = max(len(x) for x in seg_lens if np.ndim(x))
    lens = np.stack([np.broadcast_to(np.asarray(x, np.int64), (n,))
                     for x in seg_lens], axis=1)
    return np.repeat(np.tile(np.arange(len(seg_lens), dtype=np.int8), n),
                     lens.reshape(-1))


def _le_bytes(vals: np.ndarray, width: int) -> np.ndarray:
    """[n * width] little-endian bytes of n ints."""
    return ((vals[:, None] >> (8 * np.arange(width))) & 0xFF).astype(
        np.uint8).reshape(-1)


def _le(data: np.ndarray, pos, width: int) -> np.ndarray:
    """Little-endian unsigned ints of `width` bytes at byte positions."""
    pos = np.asarray(pos, dtype=np.int64)
    out = np.zeros(pos.shape, np.int64)
    for j in range(width):
        out |= data[pos + j].astype(np.int64) << (8 * j)
    return out


def write_raw_columns(path: str, hash_keys, sort_keys, values,
                      ttls) -> int:
    """Write a raw set from columns: hash_keys, sort_keys and values are
    (uint8 arena, int64 offsets, int32 lengths) triples and ttls an int
    array (absolute expire_ts, 0 = none), one row per record. Returns the
    record count. The offline-producer side (the Spark job's role)."""
    (ha, ho, hl), (sa, so, sl), (va, vo, vl) = hash_keys, sort_keys, values
    n = len(hl)
    hl, sl, vl = (np.asarray(x, np.int64) for x in (hl, sl, vl))
    ttls = np.asarray(ttls, np.int64)
    body = np.zeros(0, np.uint8)
    if n:
        if (int(hl.max()) > 0xFFFF or int(ttls.min()) < 0
                or int(max(sl.max(), vl.max(), ttls.max())) > 0xFFFFFFFF):
            raise ValueError("a length or ttl outside its u16/u32 field")
        lab = _labels(2, hl, 4, sl, 4, vl, 4)
        body = np.empty(len(lab), np.uint8)
        body[lab == 0] = _le_bytes(hl, 2)
        body[lab == 1] = _rows_bytes(ha, ho, hl)
        body[lab == 2] = _le_bytes(sl, 4)
        body[lab == 3] = _rows_bytes(sa, so, sl)
        body[lab == 4] = _le_bytes(vl, 4)
        body[lab == 5] = _rows_bytes(va, vo, vl)
        body[lab == 6] = _le_bytes(ttls, 4)
    with open(path, "wb") as f:
        f.write(RAW_MAGIC)
        f.write(body.tobytes())
    return n


def write_raw_set(path: str, records) -> int:
    """records: iterable of (hash_key, sort_key, value, ttl_seconds_abs).
    Returns the record count."""
    records = list(records)
    return write_raw_columns(
        path, _as_arena([r[0] for r in records]),
        _as_arena([r[1] for r in records]),
        _as_arena([r[2] for r in records]),
        np.fromiter((r[3] for r in records), np.int64, len(records)))


def _parse_raw(path: str) -> tuple:
    """-> (body, hl, sl, vl) of a raw set: body the uint8 record bytes
    after the magic, and each record's field lengths. Records are
    variable-length, so a record's offset depends on every earlier one:
    the walk reads three lengths per record. After a run of equal-length
    records it speculates that the following ones share them too,
    checking a doubling window of them at once and accepting the longest
    matching stretch (exactly what the record-by-record walk finds); a
    speculation that ends early doubles the run it waits for next time,
    so sets of mixed lengths stay on the plain walk. A truncated record
    raises ValueError."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:len(RAW_MAGIC)] != RAW_MAGIC:
        raise ValueError(f"{path}: bad raw-set magic")
    data = np.frombuffer(raw, np.uint8)
    total = len(raw)
    off = len(RAW_MAGIC)
    counts, hls, sls, vls = [], [], [], []
    phl = psl = pvl = -1
    same, need = 0, _RUN_TO_SPECULATE
    try:
        while off < total:
            (hl,) = _U16(raw, off)
            (sl,) = _U32(raw, off + 2 + hl)
            (vl,) = _U32(raw, off + 6 + hl + sl)
            stride = 14 + hl + sl + vl
            if off + stride > total:
                raise ValueError(f"{path}: truncated record at {off}")
            if hl == phl and sl == psl and vl == pvl:
                same += 1
                if same < need:
                    counts[-1] += 1
                    off += stride
                    continue
                count = _speculate(data, off, stride, hl, sl,
                                   (total - off) // stride)
                need = _RUN_TO_SPECULATE if count > _FIRST_WINDOW \
                    else min(need * 2, 1 << 20)
                counts[-1] += count
                off += count * stride
                same = 0
                continue
            phl, psl, pvl, same = hl, sl, vl, 0
            counts.append(1)
            hls.append(hl)
            sls.append(sl)
            vls.append(vl)
            off += stride
    except struct.error:
        raise ValueError(f"{path}: truncated record at {off}") from None
    cnt = np.asarray(counts, np.int64)
    return (data[len(RAW_MAGIC):], np.repeat(np.asarray(hls, np.int64), cnt),
            np.repeat(np.asarray(sls, np.int64), cnt),
            np.repeat(np.asarray(vls, np.int64), cnt))


def _speculate(data, off: int, stride: int, hl: int, sl: int,
               fit: int) -> int:
    """How many consecutive records from `off` (which itself has field
    lengths hl, sl and stride - 14 - hl - sl) share its lengths, at most
    `fit`: checked a doubling window at a time."""
    vl = stride - 14 - hl - sl
    count, window = 1, _FIRST_WINDOW
    while count < fit:
        k = min(window, fit - count)
        st = off + (count + np.arange(k, dtype=np.int64)) * stride
        ok = ((_le(data, st, 2) == hl)
              & (_le(data, st + 2 + hl, 4) == sl)
              & (_le(data, st + 6 + hl + sl, 4) == vl))
        if not ok.all():
            return count + int(np.argmin(ok))
        count += k
        window *= 2
    return count


def _fields(path: str) -> tuple:
    """-> (hk bytes, sk bytes, value bytes, hl, sl, vl, ttl) of a raw set:
    each field's bytes back to back in record order, its lengths, and
    the ttls."""
    body, hl, sl, vl = _parse_raw(path)
    if len(hl) == 0:
        e = np.zeros(0, np.uint8)
        return e, e, e, hl, sl, vl, hl
    lab = _labels(2, hl, 4, sl, 4, vl, 4)
    t = body[lab == 6].reshape(-1, 4).astype(np.int64)
    ttl = t[:, 0] | t[:, 1] << 8 | t[:, 2] << 16 | t[:, 3] << 24
    return (body[lab == 1], body[lab == 3], body[lab == 5], hl, sl, vl,
            ttl)


def read_raw_set(path: str):
    """-> yields (hash_key, sort_key, value, expire_ts)."""
    hk, sk, v, hl, sl, vl, ttl = _fields(path)
    ends = [np.cumsum(x).tolist() for x in (hl, sl, vl)]
    cols = (hk.tobytes(), sk.tobytes(), v.tobytes())
    starts = [0, 0, 0]
    for i in range(len(hl)):
        row = []
        for j in range(3):
            row.append(cols[j][starts[j]: ends[j][i]])
            starts[j] = ends[j][i]
        yield row[0], row[1], row[2], int(ttl[i])


def load_ingest_file(path: str, schema) -> KVBlock:
    """One ingest file -> a KVBlock: stored keys generate_key(hk, sk) and
    values schema.generate_value(ttl, 0, value), the records' order
    kept."""
    with open(path, "rb") as f:
        magic = f.read(len(SST_MAGIC))
    if magic == SST_MAGIC:
        return SSTable(path).block()
    hk, sk, v, hl, sl, vl, ttl = _fields(path)
    n = len(hl)
    if n == 0:
        return KVBlock.empty()
    if int(hl.max()) >= 0xFFFF:   # generate_key's limit
        raise ValueError("hash key length must be less than UINT16_MAX")
    # stored key = [u16 BE hk_len][hash_key][sort_key]
    klab = _labels(2, hl, sl)
    karena = np.empty(len(klab), np.uint8)
    karena[klab == 0] = np.stack([hl >> 8, hl & 0xFF], axis=1).astype(
        np.uint8).reshape(-1)
    karena[klab == 1] = hk
    karena[klab == 2] = sk
    # value = the schema's header for (expire_ts = ttl, timetag 0) + the
    # value; expire_ts is the u32 big-endian at ttl_at
    head = np.frombuffer(schema.generate_value(0, 0, b""), np.uint8)
    heads = np.tile(head, (n, 1))
    ttl_at = 1 if schema.VERSION == 2 else 0
    for j in range(4):
        heads[:, ttl_at + j] = (ttl >> (8 * (3 - j))) & 0xFF
    vlab = _labels(len(head), vl)
    varena = np.empty(len(vlab), np.uint8)
    varena[vlab == 0] = heads.reshape(-1)
    varena[vlab == 1] = v
    key_len = (2 + hl + sl).astype(np.int32)
    val_len = (len(head) + vl).astype(np.int32)
    key_off = np.zeros(n, np.int64)
    np.cumsum(key_len[:-1], out=key_off[1:])
    val_off = np.zeros(n, np.int64)
    np.cumsum(val_len[:-1], out=val_off[1:])
    hashes = _batch_key_hashes(karena, key_off, key_len)
    return KVBlock(karena, key_off, key_len, varena, val_off, val_len,
                   ttl.astype(np.uint32),
                   (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                   np.zeros(n, np.bool_))


def metadata_path(provider_root: str, app_name: str) -> str:
    return os.path.join(provider_root, app_name, "bulk_load_metadata")


def write_metadata(provider_root: str, app_name: str,
                   partition_count: int) -> dict:
    """Scan the provider tree and write the metadata file a meta server
    validates before starting a load."""
    app_root = os.path.join(provider_root, app_name, str(partition_count))
    meta = {"app_name": app_name, "partition_count": partition_count,
            "partitions": {}}
    for pidx in range(partition_count):
        pdir = os.path.join(app_root, str(pidx))
        files = []
        if os.path.isdir(pdir):
            for name in sorted(os.listdir(pdir)):
                if name.startswith("."):
                    continue  # tool state, not data
                p = os.path.join(pdir, name)
                files.append({"name": name, "size": os.path.getsize(p)})
        meta["partitions"][str(pidx)] = files
    with open(metadata_path(provider_root, app_name), "w") as f:
        json.dump(meta, f)
    return meta


def ingest_partition(engine, provider_root: str, app_name: str,
                     partition_count: int, pidx: int, schema,
                     verify_hash: bool = True) -> dict:
    """Replica-side ingestion (the ingestion_files write): load every file
    of this partition's ingest set, sort and merge them (on the engine's
    device for the cuda backend), drop rows that do not hash here, and
    install the result as the newest L0 run. Returns stats."""
    from ..ops.compact import CompactOptions, compact_blocks

    pdir = os.path.join(provider_root, app_name, str(partition_count),
                        str(pidx))
    if not os.path.isdir(pdir):
        return {"files": 0, "records": 0}
    blocks = []
    for name in sorted(os.listdir(pdir)):
        if name.startswith("."):
            continue  # tool state, not data
        blocks.append(load_ingest_file(os.path.join(pdir, name), schema))
    if not blocks:
        return {"files": 0, "records": 0}
    opts = CompactOptions(
        backend=engine.opts.backend, device=engine.opts.device,
        prefix_u32=engine.opts.prefix_u32, filter=verify_hash,
        pidx=pidx, partition_mask=(partition_count - 1) if verify_hash else 0,
        bottommost=False, runs_sorted=False, now=0,
    )
    merged = compact_blocks(blocks, opts).block
    engine.install_ingested_block(merged)
    return {"files": len(blocks), "records": int(merged.n)}
