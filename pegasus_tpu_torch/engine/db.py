"""The LSM engine: memtable + L0 runs + leveled SSTs, with device-offloaded
flush, compaction and reads.

Port of pegasus_tpu/engine/db.py, trimmed to the engine's device lane:
open/recover from MANIFEST, writes, point and range reads (device-served
from resident runs), flush, L0 and manual compaction, bulk-load install,
and the logical state digest. Its MANIFEST and SST files are those of the
JAX package, so either package opens the other's directories.

There is no internal WAL: the replication mutation log is the WAL and
replays into the engine on recovery.

Structure:
  - L0: overlapping whole-keyspace runs, newest first (flush outputs).
  - L1..max_levels: runs of non-overlapping range-partitioned files sorted
    by min_key; compaction output is split at target_file_size_bytes.
  - The L0 trigger merges L0 + overlapping L1 files into L1; size-ratio
    overflow cascades one file (+ overlap) per step into the next level.

Device lane (backend="cuda"): every flushed or compacted SST is primed
onto the device (its packed key columns and fence index) on a pipeline
pool thread, off the write path; compactions merge the resident runs,
and batched reads probe them. A device failure raises to the caller; an
async prime's failure is kept and raised to the next caller that needs
the run or settles the engine (flush, compact, manual compact, close).
The cpu backend runs only when the caller asks for it (backend="cpu").

Deferred installs: at pipeline depth > 1 an L0 or cascade merge swaps its
outputs into the levels at once and writes them on the install pool, so
the next merge overlaps the last one's write_sst; compact() drains them
before it returns, and the manifest only ever names files on disk.

Compaction scheduling: the cluster compaction scheduler's policy token
(set_compact_policy, a lease) holds the elective L0 trigger ('defer',
below the hard debt ceiling) or fires it at half the threshold
('urgent'); a lapsed token reads 'normal', the engine-local triggers.
SCHED_GATE caps the node's concurrent device compactions for elective
triggers while the scheduler's cap lease lives; with no token and the
cap at its default (0) the triggers are the plain L0 thresholds.

Compaction offload: a backend="cpu" engine holding a live placement
lease (set_offload_target) ships its merges to that compaction service
(replication/compact_offload.py) instead of merging locally. A failed
round raises; a lapsed lease compacts locally again. A cuda engine never
offloads.

Durability: the manifest's last_flushed_decree only advances to decrees
whose data is fully covered by on-disk SSTs (memtables flush oldest-first
and each records the last decree it contains).

Replication's side of the engine: hard-link checkpoints
(checkpoint.{decree} dirs, pinned by TTL leases while a learner streams
them, with a cached decree-anchored digest), apply_checkpoint (a learned
engine is a new LsmEngine; the one it replaces releases its resident runs
in close()), the corruption_hook callout, and scrub (every SST's section
checksums re-verified off the serving path).
"""

import bisect
import contextlib
import heapq
import json
import os
import shutil
import struct
import time
from dataclasses import dataclass, field

import numpy as np

from ..base.crc64 import MASK as CRC64_MASK, crc64_batch, crc64_update
from ..base.key_schema import key_hash
from ..base.utils import epoch_now
from ..base.value_schema import check_if_ts_expired
from ..ops.compact import (CompactOptions, compact_blocks, resolve_device,
                           sort_block)
from ..runtime import events, lockrank
from ..runtime.fail_points import FailPointError, inject
from ..runtime.job_trace import JOB_TRACER
from ..runtime.perf_counters import counters
from ..runtime.tasking import spawn_thread
from ..runtime.tracing import COMPACT_TRACER
from .block import KVBlock, _batch_key_hashes
from .memtable import Memtable
from .sstable import CorruptionError, SSTable, verify_sst, write_sst

MANIFEST = "MANIFEST"
CHECKPOINT_PREFIX = "checkpoint."

# meta-store keys
META_DATA_VERSION = "pegasus_data_version"
META_LAST_FLUSHED_DECREE = "pegasus_last_flushed_decree"
META_LAST_MANUAL_COMPACT_FINISH_TIME = "pegasus_last_manual_compact_finish_time"

_UNRESOLVED = object()  # get_batch: "not answered yet"

# batched reads probe an SST's resident run once it has this many
# candidate keys; below it the host binary search serves (a lone key
# never pays a device round trip). EngineOptions.device_read_min_batch
# and PEGASUS_DEVICE_READ_MIN_BATCH override it.
DEVICE_READ_MIN_BATCH = 2
# state_digest's array path: the most rows the sources newer than the
# base run may hold for a lookup of each in the base one at a time; a
# wider overlay is matched against the base by sorting
DIGEST_OVERLAY_MAX = 4096


class _HbmGauges:
    """Process-wide device-residency accounting behind the
    `engine.hbm.budget_bytes` / `engine.hbm.resident_bytes` /
    `engine.hbm.resident_ssts` gauges on /metrics (the reference's names):
    each cuda-backend engine (one per partition) reports its budget and
    usage here at open and on every prime and release, and the gauges
    publish the process sums. Leaf lock: never takes an engine lock
    (callers may hold theirs)."""

    def __init__(self):
        self._lock = lockrank.named_lock("engine.hbm_gauges")
        # id(engine) -> (budget, used_bytes, ssts)
        self._per_engine = {}  #: guarded_by self._lock

    def _publish_locked(self):  #: requires self._lock
        vals = list(self._per_engine.values())
        counters.number("engine.hbm.budget_bytes").set(
            sum(v[0] for v in vals))
        counters.number("engine.hbm.resident_bytes").set(
            sum(v[1] for v in vals))
        counters.number("engine.hbm.resident_ssts").set(
            sum(v[2] for v in vals))

    def update(self, engine) -> None:
        with self._lock:
            self._per_engine[id(engine)] = (
                engine.opts.device_cache_bytes,
                engine._device_cache_used,
                engine._device_resident_ssts)
            self._publish_locked()

    def drop(self, engine) -> None:
        with self._lock:
            self._per_engine.pop(id(engine), None)
            self._publish_locked()


HBM_GAUGES = _HbmGauges()


class _SchedGate:
    """Per-node cap on concurrent device compactions: the cluster
    compaction scheduler bounds how many device merges run at once in
    one process, so the card never convoys behind a burst of L0
    triggers. Elective (trigger-path) compactions defer at the cap;
    urgent and ceiling compactions and manual compactions always
    proceed: the cap shapes timing, never availability. max 0 (the
    default, knob PEGASUS_SCHED_MAX_DEVICE_COMPACT) disables the gate.
    A set cap is a lease (PEGASUS_SCHED_TTL_S): its expiry reverts to
    the default, so a dead scheduler never leaves a node capped. Leaf
    lock: never takes an engine lock (callers hold theirs)."""

    def __init__(self):
        self._lock = lockrank.named_lock("engine.sched_gate")
        # resolved once: enter/exit run under self._lock on every device
        # compaction, and a per-call registry lookup would nest the
        # registry lock under the gate lock each time
        self._c_running = counters.number(
            "engine.compact.sched.device_running")
        self._default = int(os.environ.get(
            "PEGASUS_SCHED_MAX_DEVICE_COMPACT", "0"))
        self._ttl_default = float(os.environ.get("PEGASUS_SCHED_TTL_S",
                                                 "30"))
        self._max = self._default      #: guarded_by self._lock
        self._max_expire = None        #: guarded_by self._lock
        self._running = 0              #: guarded_by self._lock

    def set_max(self, n, ttl_s: float = None) -> None:
        """Install a cap lease (ttl_s default PEGASUS_SCHED_TTL_S; every
        set expires, only the env default is permanent)."""
        with self._lock:
            changed = self._max != max(0, int(n))
            self._max = max(0, int(n))
            self._max_expire = time.monotonic() + (
                self._ttl_default if ttl_s is None else float(ttl_s))
            cap = self._max
        if changed:
            events.emit("sched.device_cap", cap=cap)

    def _max_locked(self) -> int:  #: requires self._lock
        if self._max_expire is not None \
                and time.monotonic() >= self._max_expire:
            self._max, self._max_expire = self._default, None
        return self._max

    def at_cap(self) -> bool:
        with self._lock:
            m = self._max_locked()
            return m > 0 and self._running >= m

    def enter(self) -> None:
        with self._lock:
            self._running += 1
            self._c_running.set(self._running)

    def exit(self) -> None:
        with self._lock:
            self._running -= 1
            self._c_running.set(self._running)

    def state(self) -> dict:
        with self._lock:
            return {"max": self._max_locked(), "default": self._default,
                    "running": self._running}


SCHED_GATE = _SchedGate()


@dataclass
class EngineOptions:
    memtable_bytes: int = 64 << 20
    l0_compaction_trigger: int = 4
    backend: str = "cuda"           # compaction_backend: "cuda" | "cpu"
    device: object = None           # cuda backend's device; None = "cuda"
    prefix_u32: int = 8
    data_version: int = 2
    pidx: int = 0
    partition_mask: int = 0         # >0 enables split stale-key GC in compaction
    default_ttl: int = 0            # table-level default_ttl app-env
    max_levels: int = 3             # L0 + sorted levels 1..max_levels
    target_file_size_bytes: int = 64 << 20   # split compaction output files
    level_base_bytes: int = 256 << 20        # L1 budget; Ln = base * ratio^(n-1)
    level_size_ratio: int = 10
    device_cache_bytes: int = 8 << 30  # device-memory budget for resident runs
    # smallest per-SST candidate batch worth a device probe (below it the
    # host binary search serves); None = PEGASUS_DEVICE_READ_MIN_BATCH,
    # default 2, so a lone sequential get or range never pays a device
    # round trip (the reference's option and knob)
    device_read_min_batch: int = None
    # value residency: pin uniform-layout value rows on the device with
    # the key columns so compaction outputs gather their values there
    device_values: bool = False
    user_ops: tuple = ()            # parsed user-specified compaction rules
    compression: str = "none"       # SST section compression: none | zlib
    checkpoint_reserve_min_count: int = 2
    checkpoint_reserve_time_seconds: int = 0  # 0 = no time-based retention


@dataclass
class WriteBatch:
    """Atomic mutation set for one decree."""

    ops: list = field(default_factory=list)  # ("put", k, v, expire) | ("del", k, b"", 0)

    def put(self, key: bytes, value: bytes, expire_ts: int = 0):
        self.ops.append(("put", key, value, expire_ts))
        return self

    def delete(self, key: bytes):
        self.ops.append(("del", key, b"", 0))
        return self


class _RevBytes:
    """bytes wrapper with inverted ordering, for descending heap merges."""

    __slots__ = ("k",)

    def __init__(self, k: bytes):
        self.k = k

    def __lt__(self, other):
        return self.k > other.k

    def __eq__(self, other):
        return self.k == other.k


class LsmEngine:
    def __init__(self, path: str, options: EngineOptions = None):
        self.path = path
        self.opts = options or EngineOptions()
        if self.opts.backend not in ("cuda", "cpu"):
            raise ValueError(f"unknown backend {self.opts.backend!r}")
        self.device = resolve_device(self.opts.device)
        self._lock = lockrank.named_rlock("engine.lock")
        self._mem = Memtable()
        self._imm = []          # immutable memtables pending flush, newest first
        self._l0 = []           # list[SSTable], newest first
        self._levels = {}       # level(int>=1) -> list[SSTable] sorted by min_key
        self._meta = {}         # the meta-CF equivalent (live, unflushed view)
        self._next_file = 1
        self._last_committed_decree = 0
        self._durable_decree = 0
        self._durable_meta = {}
        self._compact_round = {}  # level -> round-robin cursor for cascades
        # one flush drainer at a time
        self._flush_lock = lockrank.named_lock("engine.flush")
        # serializes merge phases: two concurrent merges over overlapping
        # input snapshots would write the same records twice
        self._compaction_lock = lockrank.named_rlock("engine.compaction")
        self._device_cache_used = 0     # bytes pinned by resident runs
        self._device_resident_ssts = 0
        # read-residency flag (the collector's hotkey loop drives it
        # through the set-read-residency remote command): a read-hot
        # partition keeps its SSTs primed so its batched reads probe the
        # card, and may fill its whole device budget
        self._read_hot = False         #: guarded_by self._lock
        # async primes: waiters on another thread's in-flight prime of
        # the same file; the first device failure of an async prime,
        # raised to the next flush, compaction or close
        self._prime_cv = lockrank.named_condition("engine.prime_cv",
                                                  self._lock)
        self._prime_failure = None     #: guarded_by self._lock
        self._prime_futs = []          #: guarded_by self._lock
        # deferred installs: the install jobs in flight, the consumed
        # inputs awaiting unlink, and whether the on-disk manifest lags
        # the live file set (it waits while any live file is unwritten)
        self._pending_installs = []    #: guarded_by self._lock
        self._pending_unlinks = []     #: guarded_by self._lock
        self._manifest_dirty = False   #: guarded_by self._lock
        # the cluster compaction scheduler's policy token, a lease that
        # expires back to "normal" (the engine-local triggers), and the
        # job-trace id it carries: the compaction the token triggers
        # adopts it; cleared on adoption and on expiry
        self._sched_policy = "normal"  #: guarded_by self._lock
        self._sched_reasons = ()       #: guarded_by self._lock
        self._sched_expire = 0.0       #: guarded_by self._lock
        self._sched_job = ""           #: guarded_by self._lock
        # compaction-offload placement: a service address this cpu engine
        # ships its merges to while the lease lives
        self._offload_addr = ""        #: guarded_by self._lock
        self._offload_expire = 0.0     #: guarded_by self._lock
        self._sched_ttl_s = float(os.environ.get("PEGASUS_SCHED_TTL_S",
                                                 "30"))
        # hard L0 debt ceiling (files) at which the engine-local trigger
        # always fires, defer token or not; 0 = 3x the L0 trigger
        ceil = int(os.environ.get("PEGASUS_SCHED_DEBT_CEILING_FILES", "0"))
        self._sched_ceiling = ceil if ceil > 0 else max(
            1, self.opts.l0_compaction_trigger * 3)
        # trigger-path counters, resolved once (the L0 gate runs on every
        # flush drain and maintenance poke)
        self._c_sched_ceiling = counters.rate(
            "engine.compact.sched.ceiling_override_count")
        self._c_sched_deferred = counters.rate(
            "engine.compact.sched.deferred_count")
        self._c_sched_urgent = counters.rate(
            "engine.compact.sched.urgent_count")
        self._c_sched_gate_deferred = counters.rate(
            "engine.compact.sched.gate_deferred_count")
        self._c_offload = counters.rate("engine.compact.offload_count")
        # serializes checkpoint create/rename/GC (the shared checkpoint.tmp
        # dir would race otherwise); an RLock so callers can hold it across
        # create + consume
        self.checkpoint_lock = lockrank.named_rlock("engine.checkpoint")
        # learn pins: decree -> {lease token: expiry}. A pinned decree's
        # checkpoint dir is held out of gc_checkpoints while a learner
        # streams it; leases expire, so a dead learner never wedges GC
        self._ckpt_pins = {}          #: guarded_by self.checkpoint_lock
        self._pin_token = 0           #: guarded_by self.checkpoint_lock
        # decree -> cached decree-anchored digest of that checkpoint
        self._ckpt_digests = {}       #: guarded_by self.checkpoint_lock
        mb = self.opts.device_read_min_batch
        self._device_read_min = max(1, int(
            os.environ.get("PEGASUS_DEVICE_READ_MIN_BATCH",
                           str(DEVICE_READ_MIN_BATCH)))
            if mb is None else mb)
        # corruption callout: the hosting replica installs callable(exc)
        # here; a read hitting a CorruptionError notifies it and re-raises
        self.corruption_hook = None
        # tenant accounting: the table ledger the host wires up
        # (PegasusServer.set_table_name); device probes are charged to it
        self.table_ledger = None
        os.makedirs(path, exist_ok=True)
        self._load_manifest()
        if self.opts.backend == "cuda":
            HBM_GAUGES.update(self)  # budget visible before the first prime

    # ------------------------------------------------------------------ meta

    @property
    def meta_store(self) -> dict:
        """The live meta-CF dict: what is set here persists with the next
        manifest write (the manual-compact finish time lives here)."""
        return self._meta

    def data_version(self) -> int:
        return int(self._meta.get(META_DATA_VERSION, self.opts.data_version))

    def last_durable_decree(self) -> int:
        """Decree covered by on-disk SSTs (manifest's last_flushed_decree)."""
        return int(self._durable_meta.get(META_LAST_FLUSHED_DECREE, 0))

    def last_committed_decree(self) -> int:
        return self._last_committed_decree

    # ------------------------------------------------- compaction scheduling

    def set_compact_policy(self, policy: str, reasons=(),
                           ttl_s: float = None, job: str = "") -> None:
        """Install the cluster scheduler's policy token: 'defer' holds
        the elective L0 trigger (below the hard debt ceiling), 'urgent'
        fires it at half the threshold and lets manual compactions jump
        the concurrency queue, 'normal' is the engine-local behaviour.
        The token expires after ttl_s (default PEGASUS_SCHED_TTL_S) back
        to 'normal'. `job` is the job-trace id the triggered compaction
        adopts."""
        if policy not in ("defer", "normal", "urgent"):
            raise ValueError(f"bad compaction policy {policy!r}")
        with self._lock:
            changed = self._sched_policy != policy
            self._sched_policy = policy
            self._sched_reasons = tuple(reasons)
            self._sched_expire = time.monotonic() + (
                self._sched_ttl_s if ttl_s is None else float(ttl_s))
            if job:
                self._sched_job = job
        if changed:
            # transitions only: a re-delivery every tick would be noise
            events.emit("sched.token_apply", policy=policy,
                        reasons=",".join(reasons), engine=self.path)

    def compact_policy(self) -> tuple:
        """-> (policy, reasons, expires_in_s); an expired token reads,
        and resets, as ('normal', [], 0.0)."""
        expired = None
        with self._lock:
            now = time.monotonic()
            if self._sched_policy != "normal" and now >= self._sched_expire:
                expired = self._sched_policy
                self._sched_policy, self._sched_reasons = "normal", ()
                self._sched_job = ""
            out = (self._sched_policy, list(self._sched_reasons),
                   max(0.0, self._sched_expire - now)
                   if self._sched_policy != "normal" else 0.0)
        if expired is not None:
            # a lease running out (not replaced) means the scheduler
            # stopped delivering
            events.emit("sched.token_expired", severity="warn",
                        was=expired, engine=self.path)
        return out

    def compact_policy_fast(self) -> str:
        """Lock-free policy peek for the per-write admission path (the
        debt throttle's slope depends on a defer token). Expiry is not
        checked: a just-lapsed defer reads as defer until the next
        compact_policy() resets it, one lenient admission window at
        most."""
        return self._sched_policy  #: unguarded_ok racy admission peek of an atomically-assigned str; compact_policy() under the lock is authoritative

    def compaction_debt(self) -> dict:
        """L0 file count, debt bytes (L0 bytes plus every level's
        over-budget overflow), the deferred installs still in flight and
        the hard ceiling: what stats() and the admission throttle read."""
        with self._lock:
            over = 0
            for lv in self._levels:
                if self._levels[lv]:
                    over += max(0, self._level_bytes(lv)
                                - self._level_budget(lv))
            return {"l0_files": len(self._l0),
                    "debt_bytes": sum(s.data_bytes for s in self._l0) + over,
                    "pending_installs": sum(
                        1 for f in self._pending_installs if not f.done()),
                    "ceiling_files": self._sched_ceiling}

    def compact_debt_ratio(self) -> float:
        """L0 debt as a fraction of the hard ceiling; a deliberately
        lock-free racy read (charged on every write)."""
        return len(self._l0) / float(self._sched_ceiling)

    # ------------------------------------------------------------- placement

    def set_offload_target(self, addr: str, ttl_s: float = None) -> None:
        """Install a compaction-offload placement: while the lease is live
        (ttl_s, default PEGASUS_SCHED_TTL_S = 30 s), this engine's merges
        ship to the compaction service at `addr` ("host:port"; empty =
        compact locally). Only a backend="cpu" engine offloads."""
        with self._lock:
            changed = self._offload_addr != (addr or "")
            self._offload_addr = addr or ""
            self._offload_expire = time.monotonic() + (
                self._sched_ttl_s if ttl_s is None else float(ttl_s))
        if changed:
            events.emit("offload.placement", engine=self.path,
                        service=addr or "")

    def offload_target(self):
        """The live placement address, or None (none set / lease
        lapsed)."""
        with self._lock:
            if not self._offload_addr:
                return None
            if time.monotonic() >= self._offload_expire:
                self._offload_addr = ""
                return None
            return self._offload_addr

    # ----------------------------------------------------------------- write

    def write(self, batch: WriteBatch, decree: int) -> None:
        """Apply one committed batch: data ops + decree meta update,
        atomically under the engine lock."""
        rotated = False
        with self._lock:
            for kind, key, value, expire in batch.ops:
                if kind == "put":
                    self._mem.put(key, value, expire)
                elif kind == "del":
                    self._mem.delete(key)
                else:
                    raise ValueError(f"unknown op {kind}")
            self._last_committed_decree = decree
            self._meta[META_LAST_FLUSHED_DECREE] = decree
            self._mem.last_decree = decree
            if self._mem.approximate_bytes >= self.opts.memtable_bytes:
                self._rotate_memtable_locked()
                rotated = True
        if rotated:
            self._drain_imms()

    def write_batch(self, pairs) -> None:
        """Apply a contiguous committed decree window, `pairs` =
        [(WriteBatch, decree)] in decree order, under ONE engine lock
        acquisition. Consecutive same-kind ops collapse into memtable
        put_batch/delete_batch calls; decree bookkeeping advances per
        decree."""
        if not pairs:
            return
        rotated = False
        with self._lock:
            for batch, decree in pairs:
                run_kind, run = None, []
                for op in batch.ops + [None]:  # None flushes the last run
                    kind = op[0] if op is not None else None
                    if kind != run_kind and run:
                        if run_kind == "put":
                            self._mem.put_batch(run)
                        else:
                            self._mem.delete_batch(run)
                        run = []
                    if op is None:
                        break
                    run_kind = kind
                    if kind == "put":
                        run.append((op[1], op[2], op[3]))
                    elif kind == "del":
                        run.append(op[1])
                    else:
                        raise ValueError(f"unknown op {kind}")
                self._last_committed_decree = decree
                self._meta[META_LAST_FLUSHED_DECREE] = decree
                self._mem.last_decree = decree
                if self._mem.approximate_bytes >= self.opts.memtable_bytes:
                    self._rotate_memtable_locked()
                    rotated = True
        if rotated:
            self._drain_imms()

    def put(self, key: bytes, value: bytes, expire_ts: int = 0,
            decree: int = None):
        d = decree if decree is not None else self._last_committed_decree + 1
        self.write(WriteBatch().put(key, value, expire_ts), d)

    def delete(self, key: bytes, decree: int = None):
        d = decree if decree is not None else self._last_committed_decree + 1
        self.write(WriteBatch().delete(key), d)

    # ------------------------------------------------------------------ read

    def _device_reads_on(self) -> bool:
        """Batched reads probe resident runs on the device (the cuda
        backend); the server's read coalescers batch only then."""
        return self.opts.backend == "cuda"

    def set_read_residency(self, on: bool) -> None:
        """Read-residency policy hook (the collector's hotkey loop drives
        it through the set-read-residency remote command): a read-hot
        partition primes every current SST onto the card, on the pipeline
        pool, and may fill its whole device budget, where a cold
        partition's primes stop at 7/8 of it (the headroom this pin
        claims; see _device_run_budgeted). Off only clears the flag:
        resident runs stay (compaction still wants them) and age out
        through the merge lifecycle. A pinned prime's device failure is
        kept and raised like any async prime's."""
        with self._lock:
            # under the engine lock: _device_run_budgeted reads the flag
            # to size the prime budget
            self._read_hot = bool(on)
            ssts = self._all_ssts_locked() \
                if on and self.opts.backend == "cuda" else []
        for sst in ssts:
            self._prime_async(sst)

    def get(self, key: bytes, now: int = None):
        """-> value bytes, or None (missing / deleted / expired).

        Search order = recency: memtable, immutables, L0 newest-first, then
        sorted levels. Point reads prune files by key range and hashkey
        bloom before loading data. A lone get is host-served; device
        probes run for batches (get_batch)."""
        now = epoch_now() if now is None else now
        h32 = np.uint32(key_hash(key) & 0xFFFFFFFF)
        with self._lock:
            hit = self._mem.get(key)
            if hit is None:
                for imm in self._imm:
                    hit = imm.get(key)
                    if hit is not None:
                        break
            sources = list(self._l0)
            levels = {lv: list(fs) for lv, fs in self._levels.items()}
        if hit is not None:
            value, expire, deleted = hit
            if deleted or check_if_ts_expired(now, expire):
                return None
            return value
        res = self._walk_sources([key], [now], [h32], [0], sources, levels,
                                 use_device=False)
        return res.get(0)

    @staticmethod
    def _record_or_none(block: KVBlock, i: int, now: int):
        if block.deleted[i] or check_if_ts_expired(now,
                                                   int(block.expire_ts[i])):
            return None
        return block.value(i)

    def get_batch(self, keys, now=None) -> list:
        """Batched point lookup, semantically identical to
        [get(k) for k in keys] against one consistent snapshot. `now` is a
        scalar or a per-key list.

        Memtable/immutable hits resolve on the host; the SST walk probes
        each SST's resident run on the device (ops/device_lookup.py) where
        one exists, the host binary search elsewhere: the same row index
        into the same cached block either way."""
        n = len(keys)
        if now is None:
            now = epoch_now()
        nows = list(now) if isinstance(now, (list, tuple)) else [now] * n
        out = [_UNRESOLVED] * n
        h32s = [np.uint32(key_hash(k) & 0xFFFFFFFF) for k in keys]
        with self._lock:
            for i, k in enumerate(keys):
                hit = self._mem.get(k)
                if hit is None:
                    for imm in self._imm:
                        hit = imm.get(k)
                        if hit is not None:
                            break
                if hit is not None:
                    value, expire, deleted = hit
                    out[i] = (None if deleted
                              or check_if_ts_expired(nows[i], expire)
                              else value)
            sources = list(self._l0)
            levels = {lv: list(fs) for lv, fs in self._levels.items()}
        pending = [i for i in range(n) if out[i] is _UNRESOLVED]
        if pending:
            res = self._walk_sources(keys, nows, h32s, pending, sources,
                                     levels, self._device_reads_on())
            for i, v in res.items():
                out[i] = v
        return [None if v is _UNRESOLVED else v for v in out]

    def _walk_sources(self, keys, nows, h32s, pending, sources, levels,
                      use_device) -> dict:
        """Recency-ordered SST walk for a key batch over a snapshot.
        -> {key index: value | None(resolved)}."""
        res = {}
        pend = list(pending)
        for sst in sources:
            if not pend:
                break
            cand = [i for i in pend if sst.maybe_contains_hash(h32s[i])]
            self._probe_sst(sst, cand, keys, nows, res, use_device)
            pend = [i for i in pend if i not in res]
        for lv in sorted(levels):
            if not pend:
                break
            files = levels[lv]
            mins = [f.min_key for f in files]
            by_file = {}
            for i in pend:
                j = bisect.bisect_right(mins, keys[i]) - 1
                if j >= 0 and files[j].maybe_contains_hash(h32s[i]):
                    by_file.setdefault(j, []).append(i)
            for j, cand in sorted(by_file.items()):
                self._probe_sst(files[j], cand, keys, nows, res, use_device)
            pend = [i for i in pend if i not in res]
        return res

    def _notify_corruption(self, exc) -> None:
        """Callout on a typed CorruptionError: counted, evented and
        forwarded to corruption_hook. Callers always re-raise: the client
        gets the typed error, never garbage."""
        counters.rate("engine.corruption_count").increment()
        events.emit("engine.corruption", "error",
                    path=str(getattr(exc, "path", "")),
                    detail=str(getattr(exc, "detail", exc)))
        hook = self.corruption_hook
        if hook is not None:
            try:
                hook(exc)
            except Exception as e:  # the hook must never mask the error
                print(f"[engine] corruption hook failed: {e!r}", flush=True)

    def _probe_sst(self, sst, cand, keys, nows, res, use_device) -> None:
        """Resolve one SST's candidates into `res` (hits only; a found
        tombstone/expired record resolves to None exactly like get)."""
        if not cand:
            return
        try:
            self._probe_sst_impl(sst, cand, keys, nows, res, use_device)
        except CorruptionError as e:
            self._notify_corruption(e)
            raise

    def _read_index(self, sst):
        """sst's device read index for a batched probe, or None (host
        walk). A run whose async prime failed primes here, inline: the
        kept failure raises to this reader first, and a re-prime that
        fails raises too, so a device fault never turns into a quiet
        host read."""
        if sst._prime_failed and not sst._device_retired:
            self._device_run_budgeted(sst)
        return sst.device_index

    def _probe_sst_impl(self, sst, cand, keys, nows, res, use_device) -> None:
        dr = (self._read_index(sst)
              if use_device and len(cand) >= self._device_read_min
              else None)
        if dr is not None:
            from ..ops.device_lookup import lookup_batch

            rows = lookup_batch(dr, [keys[i] for i in cand])
            if self.table_ledger is not None:
                self.table_ledger.charge_device_read(len(cand))
            block = sst.block()
            for i, r in zip(cand, rows):
                if r >= 0:
                    res[i] = self._record_or_none(block, int(r), nows[i])
            return
        for i in cand:
            row = sst.find(keys[i])
            if row >= 0:
                res[i] = self._record_or_none(sst.block(), row, nows[i])

    def scan(self, start_key: bytes = b"", stop_key: bytes = None,
             now: int = None, include_deleted: bool = False,
             reverse: bool = False, hash32=None):
        """Merged iterator over [start_key, stop_key): yields (key, value,
        expire_ts) newest-version-wins, tombstones/expired filtered.
        reverse=True iterates the same range descending. hash32: when the
        whole range lives under ONE hashkey, its hash lets the file walk
        skip SSTs whose bloom cannot hold it."""
        return self._scan_over(None, start_key, stop_key, now,
                               include_deleted, reverse, hash32)

    def _scan_snapshot(self):
        """One consistent source snapshot for a merged scan."""
        with self._lock:
            mem_items = list(self._mem.items())
            imm_items = [list(imm.items()) for imm in self._imm]
            ssts = list(self._l0)
            for lv in sorted(self._levels):
                ssts.extend(self._levels[lv])
        return mem_items, imm_items, ssts

    def _scan_over(self, snap, start_key, stop_key, now,
                   include_deleted=False, reverse=False, hash32=None,
                   sst_bounds=None):
        """The merged-scan generator over a _scan_snapshot (None = take
        one lazily on first pull). `sst_bounds` ({id(sst): (lo, hi)})
        injects pre-resolved per-SST row intervals (the device range path
        supplies them) so the IDENTICAL merge below yields the same rows
        with the host binary searches elided; an absent entry means the
        SST was pruned."""
        if snap is None:
            snap = self._scan_snapshot()
        now = epoch_now() if now is None else now
        mem_items, imm_items, ssts = snap

        def in_range(k):
            return k >= start_key and (stop_key is None or k < stop_key)

        mem_snapshot = sorted((k, v) for k, v in mem_items if in_range(k))
        imm_snapshots = [sorted((k, v) for k, v in items if in_range(k))
                         for items in imm_items]

        def mem_source(snap):
            it = reversed(snap) if reverse else snap
            for k, (v, e, d) in it:
                yield k, v, e, d

        def sst_source(sst):
            if sst_bounds is not None:
                lohi = sst_bounds.get(id(sst))
                if lohi is None or lohi[0] >= lohi[1]:
                    return  # pruned or empty interval
                b = self._sst_block(sst)
                lo, hi = lohi
            else:
                if sst.n == 0:
                    return
                if stop_key is not None and sst.min_key \
                        and sst.min_key >= stop_key:
                    return
                if start_key and sst.max_key and sst.max_key < start_key:
                    return
                if hash32 is not None and not sst.maybe_contains_hash(hash32):
                    return
                b = self._sst_block(sst)
                lo = sst.lower_bound(start_key) if start_key else 0
                hi = sst.lower_bound(stop_key) if stop_key is not None \
                    else b.n
            rng = range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)
            for i in rng:
                yield (b.key(i), b.value(i), int(b.expire_ts[i]),
                       bool(b.deleted[i]))

        sources = [mem_source(mem_snapshot)]
        sources += [mem_source(s) for s in imm_snapshots]
        sources += [sst_source(s) for s in ssts]
        # recency rank = position in `sources`; lower wins for equal keys.
        # descending merges invert the key order, not the recency order.
        hk = (lambda k: _RevBytes(k)) if reverse else (lambda k: k)
        heap = []
        for rank, src in enumerate(sources):
            it = iter(src)
            first = next(it, None)
            if first is not None:
                heap.append((hk(first[0]), rank, first, it))
        heapq.heapify(heap)
        prev_key = None
        while heap:
            _, rank, rec, it = heap[0]
            k = rec[0]
            nxt = next(it, None)
            if nxt is not None:
                heapq.heapreplace(heap, (hk(nxt[0]), rank, nxt, it))
            else:
                heapq.heappop(heap)
            if k == prev_key:
                continue  # an older version of a key already emitted/skipped
            prev_key = k
            _, v, e, d = rec
            if not include_deleted:
                if d or check_if_ts_expired(now, e):
                    continue
            yield k, v, e

    def _sst_block(self, sst):
        try:
            return sst.block()
        except CorruptionError as e:
            self._notify_corruption(e)
            raise

    def scan_range_batch(self, ranges, now=None, reverse=False,
                         hash32s=None) -> list:
        """Batched bounded scans over ONE consistent snapshot: for each
        (start_key, stop_key) in `ranges` (stop None = open end), yields
        exactly what scan(start, stop) would, but every resident SST
        resolves its per-query row intervals on the device in ONE batched
        call per SST (ops/device_lookup.py range_batch). Both paths feed
        intervals to the same merge generator (_scan_over).
        -> list of iterators, one per range, in order."""
        n = len(ranges)
        if n == 0:
            return []
        if now is None:
            now = epoch_now()
        nows = list(now) if isinstance(now, (list, tuple)) else [now] * n
        h32s = list(hash32s) if hash32s is not None else [None] * n
        snap = self._scan_snapshot()
        if reverse or not self._device_reads_on():
            return [self._scan_over(snap, s, t, nows[i], False, reverse,
                                    h32s[i])
                    for i, (s, t) in enumerate(ranges)]
        bounds = self._resolve_sst_bounds(snap[2], ranges, h32s)
        return [self._scan_over(snap, s, t, nows[i], False, False, h32s[i],
                                sst_bounds=bounds[i])
                for i, (s, t) in enumerate(ranges)]

    def _resolve_sst_bounds(self, ssts, ranges, h32s) -> list:
        """Per-(query, SST) row intervals for a range batch over a
        snapshot. -> one {id(sst): (lo, hi)} dict per query; an SST absent
        from a query's dict was pruned by exactly the host iterator's
        metadata/bloom conditions."""
        try:
            return self._resolve_sst_bounds_impl(ssts, ranges, h32s)
        except CorruptionError as e:
            self._notify_corruption(e)
            raise

    def _resolve_sst_bounds_impl(self, ssts, ranges, h32s) -> list:
        bounds = [dict() for _ in ranges]
        for sst in ssts:
            if sst.n == 0:
                continue
            cand = []
            for qi, (start_key, stop_key) in enumerate(ranges):
                if stop_key is not None and sst.min_key \
                        and sst.min_key >= stop_key:
                    continue
                if start_key and sst.max_key and sst.max_key < start_key:
                    continue
                if h32s[qi] is not None \
                        and not sst.maybe_contains_hash(h32s[qi]):
                    continue
                if not start_key and stop_key is None:
                    bounds[qi][id(sst)] = (0, sst.n)  # whole run
                    continue
                cand.append(qi)
            if not cand:
                continue
            dr = (self._read_index(sst)
                  if len(cand) >= self._device_read_min else None)
            if dr is not None:
                from ..ops.device_lookup import range_batch

                iv = range_batch(dr, [ranges[qi] for qi in cand])
                if self.table_ledger is not None:
                    self.table_ledger.charge_device_read(len(cand))
                for qi, (lo, hi) in zip(cand, iv):
                    bounds[qi][id(sst)] = (int(lo), int(hi))
                continue
            for qi in cand:
                start_key, stop_key = ranges[qi]
                lo = sst.lower_bound(start_key) if start_key else 0
                hi = sst.lower_bound(stop_key) \
                    if stop_key is not None else sst.n
                bounds[qi][id(sst)] = (lo, hi)
        return bounds

    # ------------------------------------------------------------------ audit

    def state_digest(self, now: int = None, pmask: int = None) -> dict:
        """Order-independent digest of the LIVE logical state: one crc64
        per record (key, value bytes, expire_ts) over the merged recency
        iterator, folded into an XOR and an additive sum plus a count, so
        the physical layout cannot matter, only the logical contents.
        Tombstones, expired records and (with a split mask) records the
        partition no longer owns are excluded."""
        now = epoch_now() if now is None else now
        pmask = self.opts.partition_mask if pmask is None else pmask
        crcs = self._single_run_digest_rows(now, pmask)
        if crcs is None:
            crcs = (crc64_batch(*rows)
                    for rows in self._merged_digest_rows(now, pmask))
        xor = add = records = 0
        # the per-record crc64s, vectorized over chunks of records
        for c in crcs:
            xor ^= int(np.bitwise_xor.reduce(c)) if len(c) else 0
            add = (add + int(c.sum(dtype=np.uint64))) & 0xFFFFFFFFFFFFFFFF
            records += len(c)
        return {"digest": f"{xor:016x}{add:016x}", "records": records,
                "now": now}

    def _merged_digest_rows(self, now: int, pmask: int):
        """state_digest's records over the merged scan, as chunks of
        (arena, offsets, lengths): each record u32 LE key length, the
        key, i64 LE expire_ts, the value."""
        rows = [struct.pack("<I", len(k)) + k + struct.pack("<q", int(e)) + v
                for k, v, e in self.scan(now=now)
                if not pmask or key_hash(k) % (pmask + 1) == self.opts.pidx]
        for lo in range(0, len(rows), 1 << 16):
            chunk = rows[lo: lo + (1 << 16)]
            lens = np.fromiter(map(len, chunk), np.int64, len(chunk))
            offs = np.zeros(len(chunk), np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            yield np.frombuffer(b"".join(chunk), np.uint8), offs, lens

    def _single_run_digest_rows(self, now: int, pmask: int):
        """The crc64s of the same records as _merged_digest_rows, in
        chunks, computed with array ops when one base run holds nearly
        every row. The base is the oldest source: the deepest level (a
        fully compacted replica, its output split into files of disjoint
        key ranges) or, with no level, the oldest L0 file (a loaded
        replica). What is newer is the memtables (a secondary applies the
        last committed writes with the next prepare) and the other files
        (the writes flushed since the load, which a split's learns and a
        backup's checkpoint carry). The digest ignores order, so the rows
        are the base's live rows whose keys nothing newer holds, plus the
        newer sources' newest live rows. Past DIGEST_OVERLAY_MAX rows in
        the newer sources the keys are matched by sorting
        (_wide_overlay_digest_rows). None without an SST."""
        with self._lock:
            levels = [self._levels[lv] for lv in sorted(self._levels)
                      if self._levels[lv]]
            if levels:
                base = list(levels[-1])
                newer = list(self._l0) + [f for fs in levels[:-1] for f in fs]
            elif self._l0:
                base, newer = [self._l0[-1]], list(self._l0[:-1])
            else:
                return None
            newest = {}
            for mem in [self._mem] + list(self._imm):  # newest first
                for k, ved in mem.items():
                    newest.setdefault(k, ved)
        if len(newest) + sum(f.n for f in newer) > DIGEST_OVERLAY_MAX:
            return self._wide_overlay_digest_rows(base, newer, newest, now,
                                                  pmask)
        for sst in newer:  # newest first, as the merged scan ranks them
            b = self._sst_block(sst)
            for i in range(b.n):
                newest.setdefault(b.key(i), (b.value(i), int(b.expire_ts[i]),
                                             bool(b.deleted[i])))
        def chunks():
            for sst in base:
                b = self._sst_block(sst)
                keep = np.ones(b.n, dtype=bool)
                for k in newest:
                    i = b.lower_bound(k)
                    if i < b.n and b.key(i) == k:
                        keep[i] = False
                yield from self._live_digest_rows(b, keep, now, pmask)
            yield from self._mem_digest_rows(newest, now, pmask)

        return chunks()

    def _wide_overlay_digest_rows(self, base, newer, mem: dict, now: int,
                                  pmask: int):
        """_single_run_digest_rows' chunks over an overlay too wide to look
        up key by key: every source's keys as fixed-width byte rows
        (_key_rows), deduplicated and matched by sorting. The newer files
        come newest first (one level's files are disjoint), so a key's
        first row among them is its newest file version, which counts
        unless a memtable holds the key; a base row counts unless any
        newer source holds its key."""
        blocks = [self._sst_block(s) for s in newer]
        bases = [self._sst_block(s) for s in base]
        width = max([int(b.key_len.max()) for b in blocks + bases if b.n]
                    + [len(k) for k in mem] + [1])
        mem_keys = _key_rows(_KeyList(list(mem)), width)
        file_keys = np.concatenate([_key_rows(b, width) for b in blocks]
                                   + [mem_keys[:0]])
        src = np.repeat(np.arange(len(blocks)), [b.n for b in blocks])
        row = np.concatenate([np.arange(b.n) for b in blocks]
                             + [np.zeros(0, np.int64)])
        uniq, first = np.unique(file_keys, return_index=True)
        first = first[~np.isin(uniq, mem_keys)]
        shadow = np.concatenate([uniq, mem_keys])

        def chunks():
            for b in bases:
                keep = ~np.isin(_key_rows(b, width), shadow)
                yield from self._live_digest_rows(b, keep, now, pmask)
            for i, b in enumerate(blocks):
                keep = np.zeros(b.n, dtype=bool)
                keep[row[first[src[first] == i]]] = True
                yield from self._live_digest_rows(b, keep, now, pmask)
            yield from self._mem_digest_rows(mem, now, pmask)

        return chunks()

    def _mem_digest_rows(self, mem: dict, now: int, pmask: int):
        """The crc64s of the memtables' newest live rows (`mem`: key ->
        (value, expire_ts, deleted)) as digest records."""
        rows = [
            struct.pack("<I", len(k)) + k + struct.pack("<q", int(e)) + v
            for k, (v, e, d) in sorted(mem.items())
            if not d and not check_if_ts_expired(now, e)
            and (not pmask or key_hash(k) % (pmask + 1) == self.opts.pidx)]
        if rows:
            lens = np.fromiter(map(len, rows), np.int64, len(rows))
            yield crc64_batch(np.frombuffer(b"".join(rows), np.uint8),
                              np.cumsum(lens) - lens, lens)

    def _live_digest_rows(self, b: KVBlock, keep, now: int, pmask: int):
        """The crc64s of block b's rows in `keep` (a mask: the rows no
        newer source shadows) that are live and owned, as digest
        records."""
        exp = b.expire_ts.astype(np.int64)
        keep = keep & ~b.deleted & ~((exp > 0) & (exp <= now))
        if pmask:
            hashes = _batch_key_hashes(b.key_arena, b.key_off, b.key_len)
            keep &= hashes % np.uint64(pmask + 1) == np.uint64(self.opts.pidx)
        idx = np.nonzero(keep)[0]
        for lo in range(0, len(idx), 1 << 16):
            yield _digest_crcs(b, idx[lo: lo + (1 << 16)])

    def scrub(self, rate_bytes_per_s: float = None) -> dict:
        """Background integrity pass: re-verify every landed SST's section
        checksums off the serving path (raw file reads, no block
        materialization, no device work) and check the manifest's file
        set against the directory, at most `rate_bytes_per_s` when set.
        -> {"files", "bytes", "findings": [{"path", "detail"}], "errors"}.
        Findings are returned, not acted on; an injected `scrub.verify`
        fault is an error (the file was not verified), never a finding.
        Files compacted away mid-scan, or still landing (deferred
        installs), are skipped. One "engine.scrub" job with the hops
        scrub.files and scrub.manifest."""
        with self._lock:
            paths = [s.path for s in self._all_ssts_locked() if s._on_disk]
        findings, errors = [], []
        scanned_files = scanned_bytes = 0
        t0 = time.monotonic()
        with JOB_TRACER.job("engine.scrub", path=self.path):
            with JOB_TRACER.hop("scrub.files") as attrs:
                for p in paths:
                    try:
                        inject("scrub.verify")
                        scanned_bytes += verify_sst(p)
                        scanned_files += 1
                    except FileNotFoundError:
                        continue  # compacted away mid-scan
                    except FailPointError as e:
                        errors.append({"path": p, "detail": str(e)})
                    except CorruptionError as e:
                        findings.append({"path": p, "detail": e.detail})
                    if rate_bytes_per_s and rate_bytes_per_s > 0:
                        lag = scanned_bytes / rate_bytes_per_s - (
                            time.monotonic() - t0)
                        if lag > 0:
                            time.sleep(min(lag, 1.0))
                attrs.update(files=scanned_files, bytes=scanned_bytes,
                             findings=len(findings))
            with JOB_TRACER.hop("scrub.manifest") as attrs:
                missing = self._scrub_manifest()
                attrs.update(missing=len(missing))
                findings.extend(missing)
        counters.rate("scrub.files_count").increment(scanned_files)
        counters.rate("scrub.bytes").increment(scanned_bytes)
        if findings:
            counters.rate("scrub.corruption_count").increment(len(findings))
        return {"files": scanned_files, "bytes": scanned_bytes,
                "findings": findings, "errors": errors}

    def _scrub_manifest(self) -> list:
        """Every file the on-disk MANIFEST references must exist, unless
        the live version no longer claims it (a compaction landed between
        the read and the check)."""
        mpath = os.path.join(self.path, MANIFEST)
        try:
            with open(mpath) as f:
                m = json.load(f)
            referenced = list(m.get("l0", []))
            for fs in m.get("levels", {}).values():
                referenced.extend(fs)
        except FileNotFoundError:
            return []
        except (ValueError, KeyError, TypeError) as e:
            return [{"path": mpath, "detail": f"unparseable manifest: {e}"}]
        gone = [n for n in referenced
                if not os.path.exists(os.path.join(self.path, n))]
        if not gone:
            return []
        with self._lock:
            live = self._manifest_dict_locked()
            still = set(live["l0"])
            for fs in live["levels"].values():
                still.update(fs)
        return [{"path": os.path.join(self.path, n),
                 "detail": "manifest references missing file"}
                for n in gone if n in still]

    # ----------------------------------------------------------- flush/compact

    def flush(self) -> None:
        """Rotate the memtable and flush every immutable to an L0 SST.
        Synchronous; oldest-first keeps both L0 recency order and the
        durable-decree invariant. Settles the deferred installs queued
        now (light: without the compaction lock, so a flush never waits
        out a whole cascade), then raises an async prime's device failure
        that no caller has raised yet."""
        with self._lock:
            self._rotate_memtable_locked()
        self._drain_imms()
        self._settle_installs()
        self._raise_prime_failure()

    def _drain_imms(self) -> None:
        """Flush pending immutables oldest-first under the flush lock; the
        L0 compaction trigger fires after it is released."""
        drained = False
        with self._flush_lock:
            while True:
                with self._lock:
                    if not self._imm:
                        break
                    imm = self._imm[-1]  # list is newest-first: take oldest
                self._flush_one(imm)
                drained = True
        if drained:
            self._maybe_trigger_l0()

    def _rotate_memtable_locked(self):
        if len(self._mem) == 0:
            return
        self._imm.insert(0, self._mem)
        self._mem = Memtable()
        self._mem.last_decree = self._last_committed_decree

    def _compact_options(self, **kw) -> CompactOptions:
        return CompactOptions(backend=self.opts.backend,
                              device=self.opts.device,
                              prefix_u32=self.opts.prefix_u32, **kw)

    def _flush_one(self, imm: Memtable) -> None:
        sorted_block = sort_block(imm.to_block(), self._compact_options())
        with self._lock:
            path = os.path.join(self.path, self._alloc_file_locked())
        write_sst(path, sorted_block, {"level": 0,
                                       "last_flushed_decree": imm.last_decree},
                  compression=self.opts.compression)
        sst = SSTable(path)
        sst._block = sorted_block  # already in memory: skip the disk re-read
        # flush-time residency prime, off the write path: a pool worker
        # uploads the newborn run and builds its fence index; its first
        # merge waits for that prime, and reads take the host walk until
        # it lands
        self._prime_async(sst)
        with self._lock:
            self._l0.insert(0, sst)
            self._imm.remove(imm)
            # durability advances exactly to this memtable's decree
            self._durable_decree = max(self._durable_decree, imm.last_decree)
            self._write_manifest_locked()

    def _prime_async(self, sst) -> None:
        """Device-residency prime of one file on the pipeline pool. A
        caller that needs the run waits on the file's in-flight marker
        (_device_run_budgeted); wait_primes waits for every prime queued.
        A device failure is kept and raised to the next caller that needs
        the run, or that flushes, compacts or closes the engine; it never
        turns into a host pack."""
        if self.opts.backend != "cuda":
            return
        from ..ops.pipeline import submit

        fut = submit(self._prime_job, sst)
        with self._lock:
            self._prime_futs = [f for f in self._prime_futs if not f.done()]
            self._prime_futs.append(fut)

    def wait_primes(self) -> None:
        """Block until every async prime queued so far has landed (or
        failed: the failure stays for the next caller)."""
        with self._lock:
            futs = list(self._prime_futs)
        for f in futs:
            f.wait()

    def _prime_job(self, sst) -> None:
        # the pool thread queues the upload and the fence build on the
        # device's default stream, the stream the merges and the lookups
        # run on, so every kernel that reads the run is ordered after them
        try:
            self._device_run_budgeted(sst)
        except Exception as e:  # noqa: BLE001 - kept for the next caller
            with self._lock:
                sst._prime_error = e
                sst._prime_failed = True
                if self._prime_failure is None:
                    self._prime_failure = e
            counters.rate("engine.prime_failure_count").increment()
            print(f"[engine] device-run prime failed for {sst.path}: "
                  f"{e!r}", flush=True)

    def _device_run_budgeted(self, sst):
        """Prime/fetch an SST's device-resident run under the device
        budget: past the budget the file stays host-packed (its merges
        pack and upload it per merge). A per-file in-flight marker, under
        the engine lock, keeps an async prime and an inline caller from
        uploading one file twice, without serialising primes of different
        files or holding a lock across the upload; the budget settles
        under the lock against the retired flag, so a release never
        subtracts bytes that were not added. A device failure raises, and
        an async prime's failure raises here, once, to the caller that
        needs the run."""
        if self.opts.backend != "cuda":
            return None
        want_values = self.opts.device_values
        with self._lock:
            while sst._prime_inflight:
                self._prime_cv.wait(timeout=0.05)
            err, sst._prime_error = sst._prime_error, None
            if err is not None:
                if self._prime_failure is err:
                    self._prime_failure = None
                raise err
            cached = sst._device_run
            if sst._device_retired:
                return None
            if cached is not None and (not want_values
                                       or cached.val2d is not None):
                return cached
            # a partition that is not read-hot stops priming at 7/8 of
            # its budget, keeping headroom that the hotkey loop's
            # set-read-residency pin claims
            budget = self.opts.device_cache_bytes
            if not self._read_hot:
                budget -= budget >> 3
            if self._device_cache_used >= budget:
                return cached
            sst._prime_inflight = True
        try:
            old_bytes = cached.nbytes() if cached is not None else 0
            dr = sst.device_run(self.opts.prefix_u32, self.device,
                                with_values=want_values)
            with self._lock:
                sst._prime_failed = False
                if sst._device_retired:
                    # an async prime lost the race against the merge that
                    # consumed this file: drop the upload, never the budget
                    sst._device_run = None
                    return None
                if dr is not None:
                    self._device_cache_used += dr.nbytes() - old_bytes
                    if not sst._device_budgeted:
                        self._device_resident_ssts += 1
                    sst._device_budgeted = True
                    HBM_GAUGES.update(self)
            return dr
        finally:
            with self._lock:
                sst._prime_inflight = False
                self._prime_cv.notify_all()

    def _raise_prime_failure(self) -> None:
        """Raise, once, the first async-prime device failure no caller
        has raised yet (the failed file re-primes on its next use)."""
        with self._lock:
            err, self._prime_failure = self._prime_failure, None
            if err is None:
                return
            for s in self._all_ssts_locked():
                if s._prime_error is err:
                    s._prime_error = None
        raise err

    def prime_resident_runs(self) -> int:
        """Prime every current SST onto the device now (bulk-loaded runs
        are otherwise primed by the first merge they join). -> the number
        of SSTs holding a resident run."""
        with self._lock:
            ssts = self._all_ssts_locked()
        return sum(self._device_run_budgeted(s) is not None for s in ssts)

    def _release_device_run(self, sst):
        with self._lock:
            sst._device_retired = True
            if sst._device_run is not None and sst._device_budgeted:
                self._device_cache_used -= sst._device_run.nbytes()
                self._device_resident_ssts -= 1
                HBM_GAUGES.update(self)
            sst._device_budgeted = False
            sst._device_run = None

    def _traced_compact(self, trigger: str) -> dict:
        """compact() as ONE traced background job: the merge and install
        hops (the install's on the install pool) land in its timeline. It
        adopts the id the scheduler's token delivered (the decision, the
        token and this merge share one timeline) or mints one for an
        engine-local trigger. compact() is synchronous through its
        install drain, so the job finishes with the installed files."""
        with self._lock:
            l0 = len(self._l0)
            token_job, self._sched_job = self._sched_job, ""
        jid = JOB_TRACER.begin("compact", job_id=token_job or None,
                               engine=self.path, pidx=self.opts.pidx)
        JOB_TRACER.note("engine.trigger", job_id=jid, trigger=trigger,
                        l0_files=l0)
        try:
            with JOB_TRACER.adopt(jid):
                stats = self.compact()
        except BaseException:
            JOB_TRACER.finish(jid, status="error")
            raise
        JOB_TRACER.finish(jid, input_records=stats.get("input_records", 0),
                          output_records=stats.get("output_records", 0))
        return stats

    def _maybe_trigger_l0(self) -> bool:
        """Post-flush/ingest L0 trigger behind the scheduler's token.
        With no (or an expired) token this is `len(l0) >= trigger ->
        compact()`, the engine-local trigger a dead scheduler degrades
        to. A 'defer' token holds the elective trigger until the hard
        debt ceiling, where the engine-local trigger always wins; an
        'urgent' token fires at half the threshold; an elective trigger
        of a cuda engine defers while the node's device gate is at its
        cap. -> True when a compaction ran."""
        with self._lock:
            l0 = len(self._l0)
        policy, _, _ = self.compact_policy()
        if l0 >= self._sched_ceiling:
            # the availability floor: a wedged or dead scheduler can
            # never stall compaction into a write cliff
            if policy == "defer":
                self._c_sched_ceiling.increment()
            self._traced_compact("ceiling")
            return True
        if policy == "defer":
            if l0 >= self.opts.l0_compaction_trigger:
                self._c_sched_deferred.increment()
            return False
        if policy == "urgent":
            if l0 >= max(1, self.opts.l0_compaction_trigger // 2):
                self._c_sched_urgent.increment()
                self._traced_compact("urgent")
                return True
            return False
        if l0 >= self.opts.l0_compaction_trigger:
            if self.opts.backend == "cuda" and SCHED_GATE.at_cap():
                # the node's device merges are at the cap: hold this
                # elective merge (the debt stays; the next flush, the
                # maintenance poke or the ceiling retries it)
                self._c_sched_gate_deferred.increment()
                return False
            self._traced_compact("trigger")
            return True
        return False

    def poke_compaction(self) -> bool:
        """Idle retry of the L0 trigger (the replica stub's maintenance
        loop calls it): debt that a since-expired defer token or a
        since-freed device gate left above the trigger compacts without
        waiting for the next flush. -> True when a compaction ran (the
        caller bounds its pokes per tick on this)."""
        return self._maybe_trigger_l0()

    def _bottommost(self, target_level: int) -> bool:
        """Tombstones may only drop when no lower level could hold the key."""
        return not any(self._levels.get(lv) for lv in
                       range(target_level + 1, self.opts.max_levels + 1))

    def compact(self, bottommost: bool = None, now: int = None) -> dict:
        """L0 compaction: merge all L0 runs with the overlapping L1 files
        into range-partitioned L1 output, then cascade size-triggered
        single-file compactions down the levels. At pipeline depth > 1
        the installs are deferred, so each next merge overlaps the last
        output's write-out; compact() drains them before it returns. An
        async prime's device failure not yet raised raises first."""
        self._raise_prime_failure()
        with self._compaction_lock:
            with self._lock:
                inputs = list(self._l0)
                nonzero = [s for s in inputs if s.n]
                if not nonzero:
                    return {"input_records": 0, "output_records": 0,
                            "dropped": 0}
                lo = min(s.min_key for s in nonzero)
                hi = max(s.max_key for s in nonzero)
                overlap = self._overlapping_locked(1, lo, hi)
            bm = self._bottommost(1) if bottommost is None else bottommost
            with self._device_gate():
                stats = self._merge_to_level(inputs, overlap,
                                             target_level=1, bottommost=bm,
                                             now=now, deferred=True)
                self._maybe_cascade(now)
            self._drain_pending_installs()
            return stats

    @contextlib.contextmanager
    def _device_gate(self):
        """Count a cuda engine's merge as one running device compaction
        of this node (SCHED_GATE) while it runs."""
        gated = self.opts.backend == "cuda"
        if gated:
            SCHED_GATE.enter()
        try:
            yield
        finally:
            if gated:
                SCHED_GATE.exit()

    def _overlapping_locked(self, level: int, lo: bytes, hi: bytes):
        out = []
        for f in self._levels.get(level, []):
            if f.n == 0 or lo is None:
                out.append(f)
            elif not (f.max_key < lo or f.min_key > hi):
                out.append(f)
        return out

    def _maybe_cascade(self, now=None):
        """While a level exceeds its byte budget, push one file (plus the
        next level's overlap) down: bounded-input leveled compaction.
        Installs are deferred: the level swap is immediate (so the next
        victim selection sees the new sizes) while output k's write-out,
        manifest and input unlinks run on the install pool under the
        merge of k+1."""
        with self._compaction_lock:
            for lv in range(1, self.opts.max_levels):
                while True:
                    with self._lock:
                        files = list(self._levels.get(lv, []))
                        if (not files or self._level_bytes(lv)
                                <= self._level_budget(lv)):
                            break
                        cursor = self._compact_round.get(lv, 0) % len(files)
                        self._compact_round[lv] = cursor + 1
                        victim = files[cursor]
                        overlap = self._overlapping_locked(
                            lv + 1, victim.min_key, victim.max_key)
                    self._merge_to_level([victim], overlap,
                                         target_level=lv + 1,
                                         bottommost=self._bottommost(lv + 1),
                                         now=now, deferred=True)
            self._drain_pending_installs()

    def _level_bytes(self, lv: int) -> int:
        return sum(s.data_bytes for s in self._levels.get(lv, []))

    def _level_budget(self, lv: int) -> int:
        return self.opts.level_base_bytes * (
            self.opts.level_size_ratio ** (lv - 1))

    def _merge_to_level(self, newer_files, older_files, target_level: int,
                        bottommost: bool, now=None,
                        deferred: bool = False) -> dict:
        """Merge newer_files (recency order) over older_files into
        target_level, splitting output at target_file_size_bytes.
        deferred=True at pipeline depth > 1 moves the install's disk work
        onto the install pool (_install_merge_deferred)."""
        from ..ops.merge_path import LAUNCHES
        from ..ops.pipeline import pipeline_depth

        inputs = list(newer_files) + list(older_files)
        input_blocks = [s.block() for s in inputs]
        opts = self._compact_options(
            now=now, pidx=self.opts.pidx,
            partition_mask=self.opts.partition_mask, bottommost=bottommost,
            default_ttl=self.opts.default_ttl, runs_sorted=True,
            user_ops=tuple(self.opts.user_ops))
        offload_addr = (self.offload_target() if self.opts.backend == "cpu"
                        else None)
        with JOB_TRACER.hop("engine.merge",
                            where="offload" if offload_addr else "local",
                            level=target_level, inputs=len(inputs)) as jh:
            l0 = LAUNCHES["merge_path"]
            if offload_addr:
                from ..replication.compact_offload import \
                    offload_compact_blocks

                result = offload_compact_blocks(
                    input_blocks, opts, offload_addr,
                    tenant=f"{self.opts.pidx}@{os.path.basename(self.path)}")
                self._c_offload.increment()
            else:
                device_runs = None
                if self.opts.backend == "cuda":
                    # device-resident run cache: each SST packs and
                    # uploads once in its lifetime; this and every later
                    # merge reads device memory
                    device_runs = [self._device_run_budgeted(s)
                                   for s in inputs]
                result = compact_blocks(input_blocks, opts,
                                        device_runs=device_runs)
            # the kernel calls this process counted during the hop
            jh["launches"] = LAUNCHES["merge_path"] - l0
        if deferred and pipeline_depth() > 1:
            self._install_merge_deferred(
                inputs, _split_block(result.block,
                                     self.opts.target_file_size_bytes),
                target_level)
        else:
            self._install_merge_output(newer_files, older_files,
                                       result.block, target_level)
        return result.stats

    def _install_merge_output(self, newer_files, older_files, out_block,
                              target_level: int) -> None:
        """Write + atomically swap a merge's output over its inputs."""
        out_blocks = _split_block(out_block, self.opts.target_file_size_bytes)
        inputs = list(newer_files) + list(older_files)
        new_ssts = []
        for ob in out_blocks:
            with self._lock:
                path = os.path.join(self.path, self._alloc_file_locked())
            write_sst(path, ob, {"level": target_level,
                                 "last_flushed_decree": self._durable_decree},
                      compression=self.opts.compression)
            sst = SSTable(path)
            sst._block = ob  # already in memory: skip the disk re-read
            # compaction output stays device-resident for its NEXT merge
            self._device_run_budgeted(sst)
            new_ssts.append(sst)
        with self._lock:
            self._swap_levels_locked(inputs, new_ssts, target_level)
            self._write_manifest_locked()
        for s in inputs:
            # the loaded block stays cached for readers that snapshotted
            # this SSTable; its device columns are released now
            self._release_device_run(s)
            try:
                os.unlink(s.path)
            except OSError:
                pass

    def _swap_levels_locked(self, inputs, new_ssts, target_level: int):
        """Swap the new files in and every input file out atomically."""
        gone = set(id(f) for f in inputs)
        level = [f for f in self._levels.get(target_level, [])
                 if id(f) not in gone]
        level.extend(new_ssts)
        level.sort(key=lambda s: s.min_key or b"")
        self._levels[target_level] = level
        self._l0 = [f for f in self._l0 if id(f) not in gone]
        for lv in list(self._levels):
            if lv != target_level:
                self._levels[lv] = [f for f in self._levels[lv]
                                    if id(f) not in gone]

    def _install_merge_deferred(self, inputs, out_blocks,
                                target_level: int) -> None:
        """Pipelined install: swap the outputs into the levels NOW
        (in-memory SSTables serving reads from their cached blocks) and
        move the disk work (write_sst, the residency prime, the manifest
        and the input unlinks) onto the install pool, so the next merge
        overlaps this output's write-out.

        Durability: the on-disk manifest only ever names fully written
        files (_write_manifest_locked waits while any live SST is off
        disk), and inputs are unlinked only after a manifest that no
        longer names them has landed. A crash inside the window recovers
        to the exact pre-merge on-disk state."""
        from ..ops.pipeline import submit_install

        meta = {"level": target_level,
                "last_flushed_decree": self._durable_decree}
        new_ssts = []
        for ob in out_blocks:
            with self._lock:
                path = os.path.join(self.path, self._alloc_file_locked())
            new_ssts.append(SSTable.from_block(path, ob, meta))
        with self._lock:
            self._swap_levels_locked(inputs, new_ssts, target_level)
            self._manifest_dirty = True
            self._pending_unlinks.extend(inputs)
        for s in inputs:
            # device memory back under the budget before the next merge
            self._release_device_run(s)
        fut = submit_install(self._deferred_install_job, new_ssts)
        with self._lock:
            self._pending_installs = [
                f for f in self._pending_installs if not f.done()]
            self._pending_installs.append(fut)

    def _deferred_install_job(self, new_ssts) -> None:
        """Install-pool side of a deferred install: land the output files,
        then (once every live SST is on disk) write the manifest and
        unlink the consumed inputs. Residency primes go through
        _prime_async, so this job only ever waits on the disk. It runs
        under the compaction job the pool adopted, so its hop lands in
        the same timeline as the trigger and the merge."""
        try:
            with JOB_TRACER.hop("engine.install", ssts=len(new_ssts)):
                for sst in new_ssts:
                    with self._lock:
                        if sst._device_retired:
                            # consumed by a later merge before it landed:
                            # superseded, and nothing names the path;
                            # writing it now would only leave an orphan
                            sst._on_disk = True
                            continue
                    write_sst(sst.path, sst.block(), sst.meta,
                              compression=self.opts.compression,
                              bloom=(sst.header["bloom"],
                                     sst.header["bloom_log2m"]))
                    with self._lock:
                        sst._on_disk = True
                    self._prime_async(sst)
        finally:
            self._flush_deferred_state()

    def _flush_deferred_state(self) -> None:
        """Write the deferred manifest once every live SST is on disk,
        then unlink the consumed inputs it no longer names. Only inputs
        whose own install has settled (_on_disk) unlink now: a write_sst
        in flight can never recreate a path after its unlink."""
        unlinks = []
        with self._lock:
            if self._manifest_dirty:
                self._write_manifest_locked()
            if not self._manifest_dirty:
                unlinks = [s for s in self._pending_unlinks if s._on_disk]
                self._pending_unlinks = [
                    s for s in self._pending_unlinks if not s._on_disk]
        for s in unlinks:
            try:
                os.unlink(s.path)
            except OSError:
                pass

    def _settle_installs(self) -> None:
        """Wait for the install jobs queued now and flush the deferred
        manifest, without the compaction lock (no repair pass: a failed
        job's rewrite happens in the next full drain)."""
        with self._lock:
            futures = list(self._pending_installs)
        for f in futures:
            f.wait()
        self._flush_deferred_state()

    def _drain_pending_installs(self) -> None:
        """Wait for the install jobs in flight, rewrite inline any file a
        failed job left unwritten (no manifest named it), and flush the
        deferred manifest and unlinks: the on-disk state is settled when
        this returns. Under the compaction lock: install jobs are only
        submitted while it is held, so after the waits no job can be
        writing a file the repair pass writes too."""
        with self._compaction_lock:
            with self._lock:
                futures, self._pending_installs = self._pending_installs, []
            for f in futures:
                f.wait()
            with self._lock:
                missing = [s for s in self._all_ssts_locked()
                           if not s._on_disk]
            for s in missing:
                # a second failure raises to the caller like a synchronous
                # install would, with the on-disk state still pre-merge
                write_sst(s.path, s.block(), s.meta,
                          compression=self.opts.compression,
                          bloom=(s.header["bloom"], s.header["bloom_log2m"]))
                with self._lock:
                    s._on_disk = True
            self._flush_deferred_state()
            with self._lock:
                # no install job is in flight, so whatever is still queued
                # (outputs consumed before landing, whose job died before
                # marking them) can go now
                leftover, self._pending_unlinks = self._pending_unlinks, []
                settled = not self._manifest_dirty
                if not settled:
                    self._pending_unlinks = leftover + self._pending_unlinks
            if settled:
                for s in leftover:
                    try:
                        os.unlink(s.path)
                    except OSError:
                        pass

    def manual_compact(self, bottommost: bool = True, now: int = None,
                       target_level: int = None) -> dict:
        """Full compaction: everything merged into one run at target_level
        (default: the bottommost configured level), as its own traced
        "compact" job (trigger=manual). The stats carry the per-stage
        breakdown (pack / h2d / device / gather / sst_write) under
        "trace"."""
        with JOB_TRACER.job("compact", engine=self.path,
                            pidx=self.opts.pidx, trigger="manual"):
            return self._manual_compact_traced(bottommost, now, target_level)

    def _manual_compact_traced(self, bottommost, now, target_level) -> dict:
        self.flush()
        tl = target_level or self.opts.max_levels
        stats = {"input_records": 0, "output_records": 0, "dropped": 0}
        with self._compaction_lock:
            with self._lock:
                newer = list(self._l0)
                for lv in sorted(self._levels):
                    if lv < tl:
                        newer.extend(self._levels.get(lv, []))
                older = list(self._levels.get(tl, []))
            if newer or older:
                with self._device_gate(), COMPACT_TRACER.session() as sess:
                    stats = self._merge_to_level(newer, older,
                                                 target_level=tl,
                                                 bottommost=bottommost,
                                                 now=now)
                stats = dict(stats, trace=sess.summary())
        with self._lock:
            self._meta[META_LAST_MANUAL_COMPACT_FINISH_TIME] = \
                int(time.time())
            self._write_manifest_locked()
        return stats

    def install_ingested_block(self, block: KVBlock) -> None:
        """Bulk-load install: a sorted, deduped block becomes a fresh L0
        run with the NEWEST position: it shadows any existing version of
        the same keys, at every level."""
        self.flush()  # flush first so the ingested run is the newest
        with self._lock:
            path = os.path.join(self.path, self._alloc_file_locked())
        write_sst(path, block, {"level": 0, "ingested": True,
                                "last_flushed_decree": self._durable_decree},
                  compression=self.opts.compression)
        sst = SSTable(path)
        sst._block = block  # already in memory: skip the disk re-read
        # primed like a flush output: the ingested run's reads and its
        # first merge find it on the device
        self._device_run_budgeted(sst)
        with self._lock:
            self._l0.insert(0, sst)
            self._write_manifest_locked()
        self._maybe_trigger_l0()

    # ------------------------------------------------------------ checkpoint

    def checkpoint(self, dest_dir: str, flush: bool = True) -> int:
        """Hard-link consistent snapshot into dest_dir (reference
        sync_checkpoint / copy_checkpoint_to_dir_unsafe,
        src/server/pegasus_server_impl.cpp:1666,1863). -> its decree.
        flush=False snapshots only the durable state."""
        if flush:
            self.flush()
        with self._lock:
            os.makedirs(dest_dir, exist_ok=True)
            for sst in self._all_ssts_locked():
                dst = os.path.join(dest_dir, os.path.basename(sst.path))
                if os.path.exists(dst):
                    continue
                try:
                    os.link(sst.path, dst)
                except OSError:
                    if sst._block is not None:
                        # a deferred install's output that has not landed
                        # yet (or is mid-write): the checkpoint gets its
                        # own copy from the cached block, so the snapshot
                        # neither waits on nor leaves out the install
                        write_sst(dst, sst._block, sst.meta,
                                  compression=self.opts.compression,
                                  bloom=(sst.header.get("bloom", ""),
                                         sst.header.get("bloom_log2m", 0)))
                    else:
                        shutil.copy2(sst.path, dst)
            with open(os.path.join(dest_dir, MANIFEST), "w") as f:
                json.dump(self._manifest_dict_locked(), f)
            return self.last_durable_decree()

    def sync_checkpoint(self, flush: bool = True) -> int:
        """Create <path>/checkpoint.{decree}; GC old ones. -> the decree."""
        with self.checkpoint_lock:
            tmp = os.path.join(self.path, f"{CHECKPOINT_PREFIX}tmp")
            decree = self.checkpoint(tmp, flush=flush)
            final = os.path.join(self.path, f"{CHECKPOINT_PREFIX}{decree}")
            if os.path.exists(final):
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, final)
            self.gc_checkpoints()
            return decree

    def async_checkpoint(self):
        """Background no-flush checkpoint (snapshot the durable state
        only). -> the Thread, or None when the latest checkpoint already
        covers the durable decree or one is running."""
        existing = self.list_checkpoints()
        if existing and existing[-1] >= self.last_durable_decree():
            return None
        if not self.checkpoint_lock.acquire(blocking=False):
            return None  # a checkpoint is already in flight
        self.checkpoint_lock.release()
        return spawn_thread(self.sync_checkpoint, flush=False, daemon=True,
                            name="engine-checkpoint")

    def list_checkpoints(self) -> list:
        """Sorted decrees of the checkpoint.{decree} dirs."""
        out = []
        for name in os.listdir(self.path):
            if name.startswith(CHECKPOINT_PREFIX):
                suffix = name[len(CHECKPOINT_PREFIX):]
                if suffix.isdigit():
                    out.append(int(suffix))
        return sorted(out)

    def gc_checkpoints(self) -> int:
        """Drop checkpoints beyond the count/time reserves, never a pinned
        one (reference gc_checkpoints, pegasus_server_impl.cpp:120-253)."""
        with self.checkpoint_lock:
            decrees = self.list_checkpoints()
            keep_min = max(1, self.opts.checkpoint_reserve_min_count)
            dropped = 0
            now = time.time()
            pinned = self._pinned_decrees_locked()
            for d in decrees[:-keep_min] if len(decrees) > keep_min else []:
                if d in pinned:
                    continue  # a learn streams this checkpoint's blocks
                cdir = os.path.join(self.path, f"{CHECKPOINT_PREFIX}{d}")
                if self.opts.checkpoint_reserve_time_seconds > 0:
                    age = now - os.path.getmtime(cdir)
                    if age < self.opts.checkpoint_reserve_time_seconds:
                        continue
                shutil.rmtree(cdir, ignore_errors=True)
                dropped += 1
            return dropped

    def pin_checkpoint(self, decree: int, ttl_s: float = 600.0) -> int:
        """Hold checkpoint.{decree} out of gc_checkpoints for one learn.
        Each pin is an independent TTL lease named by the returned token;
        fetch activity renews it, expiry releases it."""
        with self.checkpoint_lock:
            self._pin_token += 1
            token = self._pin_token
            self._ckpt_pins.setdefault(decree, {})[token] = \
                time.monotonic() + ttl_s
            return token

    def renew_checkpoint_pin(self, decree: int, token: int,
                             ttl_s: float) -> None:
        with self.checkpoint_lock:
            pins = self._ckpt_pins.get(decree)
            if pins and token in pins:
                pins[token] = time.monotonic() + ttl_s

    def unpin_checkpoint(self, decree: int, token: int) -> None:
        with self.checkpoint_lock:
            pins = self._ckpt_pins.get(decree)
            if pins:
                pins.pop(token, None)
            if not pins:
                self._ckpt_pins.pop(decree, None)
                self._ckpt_digests.pop(decree, None)

    def _pinned_decrees_locked(self) -> set:  #: requires self.checkpoint_lock
        now = time.monotonic()
        for d in list(self._ckpt_pins):
            live = {t: e for t, e in self._ckpt_pins[d].items() if e > now}
            if live:
                self._ckpt_pins[d] = live
            else:
                self._ckpt_pins.pop(d)
                self._ckpt_digests.pop(d, None)
        return set(self._ckpt_pins)

    def pinned_checkpoints(self) -> dict:
        """{decree: active pin count}."""
        with self.checkpoint_lock:
            self._pinned_decrees_locked()
            return {d: len(p) for d, p in self._ckpt_pins.items()}

    def checkpoint_digest(self, decree: int) -> dict:
        """Decree-anchored digest of checkpoint.{decree} (state_digest
        over a cpu engine opened on the dir): what a shipped replica must
        reproduce before it swaps its staged blocks in. Cached per decree
        with the `now` anchor and ownership mask of its first
        computation. The caller holds a pin."""
        with self.checkpoint_lock:
            hit = self._ckpt_digests.get(decree)
            if hit is not None:
                return dict(hit)
            cdir = self.get_checkpoint_dir(decree)
        # the scan runs outside the checkpoint lock; racing computers
        # differ only in the `now` anchor, setdefault keeps the first
        ver = LsmEngine(cdir, EngineOptions(
            backend="cpu", pidx=self.opts.pidx,
            prefix_u32=self.opts.prefix_u32))
        try:
            d = ver.state_digest(now=epoch_now(),
                                 pmask=self.opts.partition_mask)
        finally:
            ver.close()
        entry = {"digest": d["digest"], "records": d["records"],
                 "now": d["now"], "pmask": self.opts.partition_mask}
        with self.checkpoint_lock:
            return dict(self._ckpt_digests.setdefault(decree, entry))

    def get_checkpoint_dir(self, decree: int = None) -> str:
        """The latest (or a given) checkpoint dir (reference
        get_checkpoint, pegasus_server_impl.cpp:1941)."""
        decrees = self.list_checkpoints()
        if not decrees:
            raise FileNotFoundError("no checkpoints")
        d = decree if decree is not None else decrees[-1]
        return os.path.join(self.path, f"{CHECKPOINT_PREFIX}{d}")

    @classmethod
    def apply_checkpoint(cls, checkpoint_dir: str, dest_path: str,
                         options: EngineOptions = None) -> "LsmEngine":
        """Replace dest_path's data with the checkpoint and open it
        (reference storage_apply_checkpoint,
        pegasus_server_impl.cpp:1970)."""
        if os.path.exists(dest_path):
            shutil.rmtree(dest_path)
        os.makedirs(dest_path)
        for name in os.listdir(checkpoint_dir):
            src = os.path.join(checkpoint_dir, name)
            if os.path.isfile(src):
                try:
                    os.link(src, os.path.join(dest_path, name))
                except OSError:
                    shutil.copy2(src, os.path.join(dest_path, name))
        return cls(dest_path, options)

    # -------------------------------------------------------------- manifest

    def _all_ssts_locked(self):
        out = list(self._l0)
        for lv in sorted(self._levels):
            out.extend(self._levels[lv])
        return out

    def _alloc_file_locked(self) -> str:
        name = f"{self._next_file:06d}.sst"
        self._next_file += 1
        return name

    def _manifest_dict_locked(self) -> dict:
        meta = dict(self._meta)
        meta[META_LAST_FLUSHED_DECREE] = self._durable_decree
        return {
            "next_file": self._next_file,
            "l0": [os.path.basename(s.path) for s in self._l0],
            "levels": {str(lv): [os.path.basename(s.path) for s in fs]
                       for lv, fs in self._levels.items()},
            "meta": meta,
        }

    def _write_manifest_locked(self):
        if any(not s._on_disk for s in self._all_ssts_locked()):
            # deferred installs in flight: the manifest never names a file
            # that has not fully landed; the last install job (or a
            # drain) writes it
            self._manifest_dirty = True
            return
        data = self._manifest_dict_locked()
        tmp = os.path.join(self.path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, MANIFEST))
        self._manifest_dirty = False  # only once the replace landed
        self._durable_meta = dict(data["meta"])

    def _load_manifest(self):
        mpath = os.path.join(self.path, MANIFEST)
        if not os.path.exists(mpath):
            self._meta = {META_DATA_VERSION: self.opts.data_version}
            # adopt orphan SSTs (a manifest lost to a crash) into their
            # header level, newest file id first
            for fname in sorted(f for f in os.listdir(self.path)
                                if f.endswith(".sst")):
                sst = SSTable(os.path.join(self.path, fname))
                lv = int(sst.meta.get("level", 0))
                if lv <= 0:
                    self._l0.insert(0, sst)
                else:
                    self._levels.setdefault(lv, []).append(sst)
                self._durable_decree = max(
                    self._durable_decree,
                    int(sst.meta.get("last_flushed_decree", 0)))
                num = os.path.splitext(fname)[0]
                if num.isdigit():
                    self._next_file = max(self._next_file, int(num) + 1)
            for lv in self._levels:
                self._levels[lv].sort(key=lambda s: s.min_key or b"")
            if self._l0 or self._levels:
                self._meta[META_LAST_FLUSHED_DECREE] = self._durable_decree
                self._last_committed_decree = self._durable_decree
            self._write_manifest_locked()
            return
        with open(mpath) as f:
            m = json.load(f)
        self._next_file = m["next_file"]
        self._l0 = [SSTable(os.path.join(self.path, n)) for n in m["l0"]]
        self._levels = {int(lv): [SSTable(os.path.join(self.path, n))
                                  for n in fs]
                        for lv, fs in m["levels"].items()}
        self._meta = dict(m["meta"])
        self._durable_meta = dict(m["meta"])
        self._durable_decree = int(self._meta.get(META_LAST_FLUSHED_DECREE, 0))
        self._last_committed_decree = self._durable_decree
        self._mem.last_decree = self._last_committed_decree

    def device_resident_bytes(self) -> int:
        """Device bytes pinned by this engine's resident runs (a racy
        read, for gauges)."""
        return self._device_cache_used

    def close(self):
        """Settle the deferred installs, wait out the async primes, and
        release every device-resident run (the files stay on disk). An
        async prime's device failure not yet raised raises here, after
        the release."""
        self._drain_pending_installs()
        self.wait_primes()
        with self._lock:
            ssts = self._all_ssts_locked()
        for s in ssts:
            self._release_device_run(s)
        HBM_GAUGES.drop(self)
        self._raise_prime_failure()

    # ------------------------------------------------------------- statistics

    def stats(self) -> dict:
        with self._lock:
            debt = self.compaction_debt()  # RLock: nested re-acquire
            policy, reasons, _ = self.compact_policy()
            return {
                "compact_debt_bytes": debt["debt_bytes"],
                "pending_installs": debt["pending_installs"],
                "compact_ceiling_files": debt["ceiling_files"],
                "compact_policy": policy,
                "compact_policy_reasons": reasons,
                "compact_offload": self._offload_addr,
                "memtable_records": len(self._mem),
                "memtable_bytes": self._mem.approximate_bytes,
                "immutable_memtables": len(self._imm),
                "l0_files": len(self._l0),
                "level_files": {lv: len(fs) for lv, fs in self._levels.items()
                                if fs},
                "level_bytes": {lv: self._level_bytes(lv)
                                for lv in self._levels if self._levels[lv]},
                "total_sst_records": sum(s.n for s in self._all_ssts_locked()),
                "last_committed_decree": self._last_committed_decree,
                "last_durable_decree": self.last_durable_decree(),
                "device_resident_bytes": self._device_cache_used,
                "device_resident_ssts": self._device_resident_ssts,
                "read_hot": self._read_hot,
            }


def _split_block(block: KVBlock, target_bytes: int) -> list:
    """Split a sorted block into chunks of ~target_bytes (key+value
    arenas), preserving order; every chunk holds a disjoint key range."""
    if block.n == 0:
        return [block]
    total = block.key_bytes_total + block.val_bytes_total
    if total <= target_bytes:
        return [block]
    sizes = block.key_len.astype(np.int64) + block.val_len.astype(np.int64)
    cum = np.cumsum(sizes)
    bounds = []
    start = 0
    base = 0
    for _ in range(int(total // target_bytes) + 1):
        cut = np.searchsorted(cum, base + target_bytes, side="left") + 1
        cut = min(int(cut), block.n)
        if cut <= start:
            cut = start + 1
        bounds.append((start, cut))
        if cut >= block.n:
            break
        start = cut
        base = int(cum[cut - 1])
    return [block.gather(np.arange(s, e, dtype=np.int64)) for s, e in bounds]


class _KeyList:
    """Python byte-string keys in the arena form _key_rows reads."""

    def __init__(self, keys):
        self.n = len(keys)
        self.key_len = np.fromiter(map(len, keys), np.int64, self.n)
        self.key_off = np.cumsum(self.key_len) - self.key_len
        self.key_arena = np.frombuffer(b"".join(keys), np.uint8)


def _key_rows(b, width: int, chunk: int = 1 << 16) -> np.ndarray:
    """Each key of b (a KVBlock or _KeyList) as one fixed-width void
    scalar: the key zero-padded to `width` bytes, then its length as
    big-endian u16, so equal rows are equal keys (a trailing zero byte
    cannot alias a shorter key)."""
    out = np.zeros((b.n, width + 2), np.uint8)
    cols = np.arange(width, dtype=np.int64)
    kl_all = b.key_len.astype(np.int64)
    for lo in range(0, b.n, chunk):
        kl = kl_all[lo: lo + chunk]
        inside = cols[None, :] < kl[:, None]
        at = b.key_off[lo: lo + chunk].astype(np.int64)[:, None] + cols
        out[lo: lo + chunk, :width][inside] = b.key_arena[at[inside]]
    out[:, width] = kl_all >> 8
    out[:, width + 1] = kl_all & 0xFF
    return out.view(np.dtype((np.void, width + 2))).ravel()


def _digest_crcs(b: KVBlock, idx: np.ndarray) -> np.ndarray:
    """state_digest's per-record crc64 of block rows idx, each over u32
    LE key length, key, i64 LE expire_ts, value: the record hashed part
    by part, straight from the block's arenas."""
    n = len(idx)
    kl = b.key_len[idx].astype(np.int64)
    vl = b.val_len[idx].astype(np.int64)
    crc = np.full(n, CRC64_MASK, dtype=np.uint64)
    crc = crc64_update(crc, kl.astype("<u4").view(np.uint8),
                       np.arange(n, dtype=np.int64) * 4, np.full(n, 4))
    crc = crc64_update(crc, b.key_arena, b.key_off[idx], kl)
    crc = crc64_update(crc, b.expire_ts[idx].astype("<i8").view(np.uint8),
                       np.arange(n, dtype=np.int64) * 8, np.full(n, 8))
    crc = crc64_update(crc, b.val_arena, b.val_off[idx], vl)
    return crc ^ np.uint64(CRC64_MASK)
