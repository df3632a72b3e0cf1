"""Block-shipped learning: streaming, delta-aware SST transfer.

Port of pegasus_tpu/replication/learn.py, with RemoteLearnSource, the
learn protocol's client over RPC (RPC_LEARN_{PREPARE,FETCH,TAIL,FINISH},
served by replication/replica_stub.py). A learner re-seeds from its primary in four
steps:

  1. the learner sends its live SST set (filename + content digest);
  2. the primary pins an immutable checkpoint (checkpoint GC and plog GC
     of covered segments are held while pinned, as TTL leases) and
     replies with the full block manifest and the blocks the learner
     is missing;
  3. the learner stages blocks into ``learn_ckpt/``: blocks already
     staged by an interrupted ship and digest-matching live files are
     reused (delta + resume at block granularity), the rest stream as
     bounded chunks with a per-chunk CRC, and every landed block
     re-verifies its whole-file digest;
  4. the swap into the serving engine is a short critical section, after
     the staged state proved itself against the checkpoint's
     decree-anchored digest (replication/replica.py).

Counters (learner side): ``learn.ship.{blocks,bytes,duration_us,
delta_skipped_blocks}``, ``learn.replay.mutations`` and
``learn.verify.{incremental,rescan}_count``.
"""

import hashlib
import json
import os
import zlib

from ..base.crc64 import crc64
from ..rpc import codec
from ..rpc import messages as rpc_msg
from ..rpc.transport import RpcError
from ..runtime.fail_points import inject
from ..runtime.job_trace import JOB_TRACER
from ..runtime.perf_counters import counters

# the arrival-proof counters exist (at zero) before the first learn
counters.rate("learn.verify.incremental_count")
counters.rate("learn.verify.rescan_count")


class LearnShipError(ConnectionError):
    """A block ship failed (chunk CRC, digest mismatch, expired pin). A
    ConnectionError: every learn caller already treats one as "this learn
    failed, retry later"."""


def chunk_bytes() -> int:
    """PEGASUS_LEARN_CHUNK_BYTES: the bounded streaming chunk size."""
    return max(4096, int(os.environ.get("PEGASUS_LEARN_CHUNK_BYTES",
                                        str(1 << 20))))


def delta_enabled() -> bool:
    """PEGASUS_LEARN_DELTA=0 is the delta kill switch: every learn ships
    the whole checkpoint (streaming and resume still apply)."""
    return os.environ.get("PEGASUS_LEARN_DELTA", "1") != "0"


def verify_enabled() -> bool:
    """PEGASUS_LEARN_VERIFY=0 skips the decree-anchored digest proof on
    arrival (the per-chunk CRC and per-block digest checks always run)."""
    return os.environ.get("PEGASUS_LEARN_VERIFY", "1") != "0"


def pin_ttl_s() -> float:
    """PEGASUS_LEARN_PIN_TTL_S: the checkpoint/log pin lease per learn,
    renewed by fetch activity (it bounds learner death, not learn
    duration)."""
    return float(os.environ.get("PEGASUS_LEARN_PIN_TTL_S", "600"))


def incremental_digest_enabled() -> bool:
    """PEGASUS_LEARN_INCREMENTAL_DIGEST=0 sends the learner's arrival
    proof back to the full staged-state rescan."""
    return os.environ.get("PEGASUS_LEARN_INCREMENTAL_DIGEST", "1") != "0"


def manifest_fold(entries) -> str:
    """Commutative fold over a block manifest's (name, digest) pairs:
    the incremental staged-state digest. stage_blocks keeps the same fold
    over the blocks it verified, so equality with the manifest's fold
    says every manifest entry went through a verification path. XOR and
    additive sum of a crc64 per entry (the state_digest combine), so
    block order cannot matter."""
    xor = add = 0
    for e in entries:
        name = e["name"] if isinstance(e, dict) else e[0]
        digest = e["digest"] if isinstance(e, dict) else e[1]
        c = crc64(name.encode() + b"\x00" + digest.encode())
        xor ^= c
        add = (add + c) & 0xFFFFFFFFFFFFFFFF
    return f"{xor:016x}{add:016x}"


def chunk_waves(total: int, chunk: int, wave_bytes: int = 8 << 20):
    """Yield bounded waves of (offset, length) descriptors covering a
    `total`-byte block: the one chunk grid under every chunked transfer
    (learn fetch, offload ship and fetch). Each wave's in-flight bytes
    stay under `wave_bytes`; a zero-byte block still yields its single
    empty-chunk descriptor."""
    offs = list(range(0, total, chunk)) or [0]
    per = max(1, wave_bytes // chunk)
    for i in range(0, len(offs), per):
        yield [(off, min(chunk, max(0, total - off)))
               for off in offs[i:i + per]]


def file_digest(path: str) -> str:
    """Content digest for block identity (md5: a transfer-dedup key, not
    a security boundary; wire corruption is caught by the per-chunk CRC
    and this digest together)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def dir_manifest(dirpath: str, suffix: str = None) -> list:
    """[{"name", "size", "digest"}] of the regular files in `dirpath`
    (optionally only names ending with `suffix`), sorted by name. Files
    that vanish mid-scan are skipped: the manifest is a best-effort
    "what do I already hold" set."""
    out = []
    if not os.path.isdir(dirpath):
        return out
    for name in sorted(os.listdir(dirpath)):
        if suffix is not None and not name.endswith(suffix):
            continue
        if name.endswith(".part"):
            continue  # torn partial from an interrupted ship
        if name.startswith("."):
            continue  # sidecar state (.staged.json), never a block
        p = os.path.join(dirpath, name)
        try:
            if not os.path.isfile(p):
                continue
            out.append({"name": name, "size": os.path.getsize(p),
                        "digest": file_digest(p)})
        except OSError:
            continue
    return out


_SIDECAR = ".staged.json"


def _load_sidecar(dest_dir: str) -> dict:
    """{name: {"digest", "size", "mtime_ns"}} of blocks a prior
    stage_blocks verified into `dest_dir`: a stat match against the
    recorded identity replaces the md5 rescan on resume."""
    try:
        with open(os.path.join(dest_dir, _SIDECAR)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_sidecar(dest_dir: str, entries: dict) -> None:
    tmp = os.path.join(dest_dir, _SIDECAR + ".tmp")
    try:
        with open(tmp, "w") as f:
            json.dump(entries, f)
        os.replace(tmp, os.path.join(dest_dir, _SIDECAR))
    except OSError:
        pass  # best effort: a lost sidecar re-hashes next learn


def _stat_entry(path: str, digest: str) -> dict:
    st = os.stat(path)
    return {"digest": digest, "size": st.st_size,
            "mtime_ns": st.st_mtime_ns}


def _link_or_copy(src: str, dst: str) -> None:
    import shutil

    if os.path.exists(dst):
        os.unlink(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _fetch_block(source, learn_id: int, entry: dict, dest_dir: str) -> int:
    """Stream one block from the source as bounded chunks (per-chunk
    CRC) and land it atomically (.part + rename) once its whole-file
    digest matched the manifest entry. -> bytes fetched."""
    inject("learn.ship")  # chaos seam: a mid-ship abort on the learner
    name, total = entry["name"], entry["size"]
    part = os.path.join(dest_dir, name + ".part")
    fetched = 0
    with open(part, "wb") as f:
        for wave in chunk_waves(total, chunk_bytes()):
            reqs = [(name, off, ln) for off, ln in wave]
            chunks = source.fetch_learn_chunks(learn_id, reqs)
            for (_, off, ln), ch in zip(reqs, chunks):
                data = ch["data"]
                if len(data) != ln or zlib.crc32(data) != ch["crc"]:
                    raise LearnShipError(
                        f"chunk CRC/length mismatch for {name}@{off}")
                f.write(data)
                fetched += len(data)
    if file_digest(part) != entry["digest"]:
        os.unlink(part)
        raise LearnShipError(f"shipped block {name} digest mismatch")
    os.replace(part, os.path.join(dest_dir, name))
    return fetched


def stage_blocks(source, st: dict, dest_dir: str, reuse: dict = None,
                 delta: bool = None) -> dict:
    """Materialize the learn manifest ``st["blocks"]`` into `dest_dir`
    exactly: already-staged blocks whose digest matches are kept
    (resume), digest-matching local files from `reuse` ({digest: path})
    are hard-linked in (delta skip), everything else streams from
    `source` in CRC-checked chunks. delta=False disables both reuse and
    resume. Files not in the manifest are pruned, so the staged dir is
    swap-ready. -> stats dict, with "fold" the manifest_fold of the
    blocks verified."""
    os.makedirs(dest_dir, exist_ok=True)
    delta = delta_enabled() if delta is None else bool(delta)
    stats = {"blocks": len(st["blocks"]), "fetched": 0, "bytes": 0,
             "skipped": 0, "resumed": 0}
    reuse = dict(reuse or {}) if delta else {}
    sidecar = _load_sidecar(dest_dir) if delta else {}
    verified = []  # (name, digest) pairs proven this stage
    want = {e["name"] for e in st["blocks"]}
    for name in os.listdir(dest_dir):
        if name not in want and not name.startswith("."):
            sidecar.pop(name, None)
            try:
                os.unlink(os.path.join(dest_dir, name))
            except OSError:
                pass
    c_blocks = counters.rate("learn.ship.blocks")
    c_bytes = counters.rate("learn.ship.bytes")
    c_skip = counters.rate("learn.ship.delta_skipped_blocks")
    try:
        for entry in st["blocks"]:
            dst = os.path.join(dest_dir, entry["name"])
            if delta:
                side = sidecar.get(entry["name"])
                try:
                    if side is not None and side["digest"] == entry["digest"] \
                            and _stat_entry(dst, entry["digest"]) == side:
                        # identity unchanged since the last verified
                        # stage: O(1), no re-hash
                        stats["resumed"] += 1
                        verified.append((entry["name"], entry["digest"]))
                        c_skip.increment()
                        continue
                except OSError:
                    pass
                try:
                    if os.path.isfile(dst) \
                            and file_digest(dst) == entry["digest"]:
                        stats["resumed"] += 1  # staged by an interrupted ship
                        sidecar[entry["name"]] = _stat_entry(
                            dst, entry["digest"])
                        verified.append((entry["name"], entry["digest"]))
                        c_skip.increment()
                        continue
                except OSError:
                    pass
                src = reuse.get(entry["digest"])
                if src is not None:
                    try:
                        _link_or_copy(src, dst)
                        # a hard link shares the inode whose digest the
                        # caller's have-manifest just computed; a copy
                        # re-hashes
                        same_inode = os.stat(dst).st_ino == \
                            os.stat(src).st_ino
                        if same_inode or file_digest(dst) == entry["digest"]:
                            stats["skipped"] += 1  # delta: learner had it
                            sidecar[entry["name"]] = _stat_entry(
                                dst, entry["digest"])
                            verified.append((entry["name"], entry["digest"]))
                            c_skip.increment()
                            continue
                        os.unlink(dst)
                    except OSError:
                        pass  # vanished under us: stream it instead
            stats["bytes"] += _fetch_block(source, st["learn_id"], entry,
                                           dest_dir)
            stats["fetched"] += 1
            sidecar[entry["name"]] = _stat_entry(dst, entry["digest"])
            verified.append((entry["name"], entry["digest"]))
            c_blocks.increment()
    finally:
        # partial progress persists: an aborted ship's retry resumes
        # against what landed (the sidecar names only verified blocks)
        _save_sidecar(dest_dir, sidecar)
    c_bytes.increment(stats["bytes"])
    stats["fold"] = manifest_fold(verified)
    return stats


class RemoteLearnSource:
    """Learn-protocol client over the RPC transport, the learn surface of
    the replica stub's remote peer. Chunk fetches pipeline through
    ``call_many`` (one coalesced send per wave) on the partition's
    sharded connection."""

    def __init__(self, pool, addr: str, app_id: int, pidx: int,
                 timeout: float = 30.0):
        self.pool = pool
        self.addr = addr
        self.app_id = app_id
        self.pidx = pidx
        self.timeout = timeout

    def _conn(self):
        host, _, port = self.addr.rpartition(":")
        return self.pool.get((host, int(port)),
                             shard=("rep", self.app_id, self.pidx))

    def _call(self, code: str, req, resp_cls):
        try:
            _, body = self._conn().call(
                code, codec.encode(req), app_id=self.app_id,
                partition_index=self.pidx, timeout=self.timeout)
        except (RpcError, OSError) as e:
            raise ConnectionError(str(e))
        resp = codec.decode(resp_cls, body)
        if resp.error:
            raise LearnShipError(f"{code} failed: {resp.error_text}")
        return resp

    def prepare_learn_state(self, have=None, delta=None) -> dict:
        from .replica_stub import RPC_LEARN_PREPARE

        req = rpc_msg.LearnPrepareRequest(
            app_id=self.app_id, pidx=self.pidx,
            delta=delta_enabled() if delta is None else bool(delta),
            have=[rpc_msg.LearnBlockEntry(e["name"], e["size"], e["digest"])
                  for e in (have or [])],
            # the learn job's trace id: the serving primary attributes its
            # checkpoint pin to this learn's timeline
            job=JOB_TRACER.current() or "")
        resp = self._call(RPC_LEARN_PREPARE, req,
                          rpc_msg.LearnPrepareResponse)
        return {
            "learn_id": resp.learn_id, "ckpt_decree": resp.ckpt_decree,
            "ballot": resp.ballot, "last_committed": resp.last_committed,
            "blocks": [{"name": e.name, "size": e.size, "digest": e.digest}
                       for e in resp.blocks],
            "missing": list(resp.missing), "digest": resp.digest,
            "digest_now": resp.digest_now, "digest_pmask": resp.digest_pmask,
        }

    def fetch_learn_chunks(self, learn_id: int, reqs) -> list:
        from .replica_stub import RPC_LEARN_FETCH

        calls = [(RPC_LEARN_FETCH,
                  codec.encode(rpc_msg.LearnFetchRequest(
                      app_id=self.app_id, pidx=self.pidx, learn_id=learn_id,
                      name=name, offset=off, length=ln)),
                  self.app_id, self.pidx, 0) for (name, off, ln) in reqs]
        try:
            results = self._conn().call_many(calls, timeout=self.timeout)
        except (RpcError, OSError) as e:
            raise ConnectionError(str(e))
        out = []
        for _, body in results:
            resp = codec.decode(rpc_msg.LearnFetchResponse, body)
            if resp.error:
                raise LearnShipError(f"learn fetch failed: {resp.error_text}")
            out.append({"data": resp.data, "crc": resp.crc,
                        "total": resp.total})
        return out

    def fetch_learn_tail(self, learn_id: int) -> dict:
        from .mutation_log import LogMutation
        from .replica_stub import RPC_LEARN_TAIL

        resp = self._call(RPC_LEARN_TAIL,
                          rpc_msg.LearnTailRequest(
                              app_id=self.app_id, pidx=self.pidx,
                              learn_id=learn_id),
                          rpc_msg.LearnTailResponse)
        return {"tail": [codec.decode(LogMutation, t) for t in resp.tail],
                "last_committed": resp.last_committed, "ballot": resp.ballot}

    def finish_learn(self, learn_id: int) -> None:
        from .replica_stub import RPC_LEARN_FINISH

        try:
            self._call(RPC_LEARN_FINISH,
                       rpc_msg.LearnFinishRequest(
                           app_id=self.app_id, pidx=self.pidx,
                           learn_id=learn_id),
                       rpc_msg.LearnFetchResponse)
        except (ConnectionError, LearnShipError):
            pass  # the pin's TTL covers an unreachable primary
