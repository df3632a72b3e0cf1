"""Private mutation log (plog): the replica's WAL.

Port of pegasus_tpu/replication/mutation_log.py, whole. Every prepared
mutation appends here before it is acknowledged, and replay-on-open
re-applies committed-but-unflushed mutations to the engine (the engine
has no WAL of its own: this log is the WAL).

File format, the same bytes as the JAX package's for the same mutations
(each package replays the other's log): segments log.{start_decree} of
framed records

    [u32 len][u32 crc32][payload]

payload = codec-encoded LogMutation. A torn tail (a crash mid-append) is
detected by length/crc and truncated at replay. Segments roll at
`segment_bytes`; gc drops whole segments whose decrees are all <= the
durable decree.

Group commit: appends buffer into a bounded group; the first appender
with no active leader claims everything buffered and lands it with one
buffered write and one flush (and one fsync when `fsync=True`);
appenders arriving meanwhile form the next group. PEGASUS_PLOG_GROUP_N
caps mutations per group (32), PEGASUS_PLOG_GROUP_US (500) bounds how
long a leader that claimed a concurrent group lingers for stragglers (a
solo appender never lingers), and PEGASUS_PLOG_GROUP_STALL_MS (500)
bounds how long an unclaimed append waits behind a wedged leader (the
`plog.group` fail point) before it lands on its own. An append returns
only once its group is durable. Group sizes export as
`plog.append.group_size`, flushes as `plog.append.flush_count`.
"""

import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import List

from ..rpc import codec
from ..runtime import lockrank
from ..runtime.fail_points import inject
from ..runtime.perf_counters import counters
from ..runtime.tracing import REQUEST_TRACER

_FRAME = struct.Struct("<II")


class _GroupEntry:
    """One append (or one decree window) waiting for its group to land."""

    __slots__ = ("frames", "decrees", "done", "err")

    def __init__(self, frames, decrees):
        self.frames = frames
        self.decrees = decrees
        self.done = False
        self.err = None


@dataclass
class LogMutation:
    """One decree's mutation batch as it travels prepare->log->apply.
    Field order is the wire and on-disk contract (the codec is
    positional), the unused `requests` field included."""

    decree: int = 0
    ballot: int = 0
    timestamp_us: int = 0
    requests: List[tuple] = field(default_factory=list)  # unused; see codes/bodies
    # the codec has no tuple support: parallel lists keep the frame simple
    codes: List[str] = field(default_factory=list)
    bodies: List[bytes] = field(default_factory=list)


class MutationLog:
    def __init__(self, log_dir: str, segment_bytes: int = 32 << 20,
                 fsync: bool = False, group_n: int = None,
                 group_us: int = None):
        self.dir = log_dir
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self.group_n = group_n if group_n is not None else \
            int(os.environ.get("PEGASUS_PLOG_GROUP_N", 32))
        self.group_us = group_us if group_us is not None else \
            int(os.environ.get("PEGASUS_PLOG_GROUP_US", 500))
        self._stall_s = float(
            os.environ.get("PEGASUS_PLOG_GROUP_STALL_MS", 500)) / 1e3
        self._lock = lockrank.named_lock("plog.file")
        self._gcv = lockrank.named_condition("plog.group")
        self._gbuf = []            #: guarded_by self._gcv
        self._gleader = False      #: guarded_by self._gcv
        self._degraded_until = 0.0  #: guarded_by self._gcv
        # monotonic totals (tests assert the grouping ratio)
        self.append_count = 0      #: guarded_by self._lock
        self.flush_count = 0       #: guarded_by self._lock
        self._file = None          #: guarded_by self._lock
        self._file_start = None    #: guarded_by self._lock
        self._file_bytes = 0       #: guarded_by self._lock
        self.last_decree = 0       #: guarded_by self._lock
        os.makedirs(log_dir, exist_ok=True)
        self._segments = self._scan_segments()
        if self._segments:
            self.last_decree = self._tail_decree()

    # ----------------------------------------------------------------- write

    @staticmethod
    def _frame(m: LogMutation) -> bytes:
        payload = codec.encode(m)
        return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload

    def append(self, m: LogMutation) -> None:
        """Append one mutation; returns once it is durable."""
        self._submit(_GroupEntry([self._frame(m)], [m.decree]))

    def append_window(self, ms: List[LogMutation]) -> None:
        """Append a contiguous decree window as ONE group member: one
        buffered write + one flush for the whole window."""
        if not ms:
            return
        self._submit(_GroupEntry([self._frame(m) for m in ms],
                                 [m.decree for m in ms]))

    def _submit(self, entry: _GroupEntry) -> None:
        t0 = time.perf_counter()
        nbytes = sum(len(f) for f in entry.frames)
        with REQUEST_TRACER.span("plog.append", decree=entry.decrees[-1],
                                 bytes=nbytes, batch=len(entry.frames)):
            if time.monotonic() < self._degraded_until:
                # a recent group leader wedged: per-append landing keeps the
                # partition moving until the cooldown ends
                self._write_group([entry])
            else:
                self._group_commit(entry)
        if entry.err is not None:
            raise entry.err
        counters.rate("plog.append.count").increment(len(entry.frames))
        counters.rate("plog.append.bytes").increment(nbytes)
        counters.percentile("plog.append.duration_us").set(
            int((time.perf_counter() - t0) * 1e6))

    def _group_commit(self, entry: _GroupEntry) -> None:
        """Leader/follower group commit. A follower whose entry is still
        unclaimed after _stall_s takes it back and lands it alone."""
        with self._gcv:
            self._gbuf.append(entry)
            self._gcv.notify_all()  # wake a lingering leader
        while True:
            fallback = False
            with self._gcv:
                if entry.done:
                    return
                if self._gleader:
                    if self._gcv.wait(self._stall_s):
                        continue
                    if entry not in self._gbuf:
                        continue  # claimed: durability requires waiting
                    self._gbuf.remove(entry)
                    self._degraded_until = time.monotonic() + self._stall_s
                    fallback = True
                else:
                    self._gleader = True
                    batch = self._claim_locked([])
            if fallback:
                counters.rate("plog.group.fallback_count").increment()
                self._write_group([entry])
                return
            # leader, outside the cv: stragglers queue for the next group
            try:
                if len(batch) >= 2 and self.group_us > 0:
                    batch = self._linger(batch)
                inject("plog.group")  # chaos seam: between claim and flush
                self._write_group(batch)
            except Exception as e:  # noqa: BLE001 - every member must see it
                err = e if isinstance(e, OSError) else OSError(
                    f"plog group write failed: {e!r}")
                for b in batch:
                    b.err = err
            finally:
                with self._gcv:
                    self._gleader = False
                    for b in batch:
                        b.done = True
                    self._gcv.notify_all()

    def _claim_locked(self, batch: list) -> list:  #: requires self._gcv
        """Move buffered entries into `batch` up to the group_n cap."""
        total = sum(len(b.frames) for b in batch)
        while self._gbuf and total < self.group_n:
            e = self._gbuf.pop(0)
            batch.append(e)
            total += len(e.frames)
        return batch

    def _linger(self, batch: list) -> list:
        """A leader that claimed a concurrent group (>= 2 members) waits
        up to group_us for stragglers, growing toward group_n."""
        deadline = time.monotonic() + self.group_us / 1e6
        while sum(len(b.frames) for b in batch) < self.group_n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            with self._gcv:
                if not self._gbuf:
                    self._gcv.wait(remaining)
                batch = self._claim_locked(batch)
        return batch

    def _write_group(self, batch: list) -> None:
        """Land a claimed group: one buffered write + one flush (+ one
        fsync when armed) for every frame of every member."""
        n_frames = sum(len(b.frames) for b in batch)
        blob = b"".join(f for b in batch for f in b.frames)
        first_decree = batch[0].decrees[0]
        with self._lock:
            if self._file is None or self._file_bytes >= self.segment_bytes:
                self._roll_locked(first_decree)
            self._file.write(blob)
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self._file_bytes += len(blob)
            for b in batch:
                self.last_decree = max(self.last_decree, b.decrees[-1])
            self.append_count += n_frames
            self.flush_count += 1
        counters.rate("plog.append.flush_count").increment()
        counters.percentile("plog.append.group_size").set(n_frames)

    def _roll_locked(self, start_decree: int) -> None:  #: requires self._lock
        if self._file:
            self._file.close()
        path = os.path.join(self.dir, f"log.{start_decree}")
        self._file = open(path, "ab")
        self._file_start = start_decree
        self._file_bytes = self._file.tell()
        if start_decree not in self._segments:
            self._segments.append(start_decree)
            self._segments.sort()

    # ------------------------------------------------------------------ read

    def replay(self, from_decree: int = 0):
        """Yield LogMutations with decree > from_decree, in append order.
        Stops (and truncates) at the first torn record."""
        with self._lock:
            segments = list(self._segments)
            if self._file:
                self._file.flush()
        for i, start in enumerate(segments):
            # skip segments that end before the replay point
            if i + 1 < len(segments) and segments[i + 1] <= from_decree + 1:
                continue
            path = os.path.join(self.dir, f"log.{start}")
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off + _FRAME.size <= len(data):
                length, crc = _FRAME.unpack_from(data, off)
                body = data[off + _FRAME.size: off + _FRAME.size + length]
                if len(body) < length or zlib.crc32(body) != crc:
                    self._truncate_torn(path, off)
                    return
                off += _FRAME.size + length
                m = codec.decode(LogMutation, body)
                if m.decree > from_decree:
                    yield m

    def _truncate_torn(self, path: str, valid_bytes: int) -> None:
        with self._lock:
            if self._file and os.path.join(
                    self.dir, f"log.{self._file_start}") == path:
                self._file.truncate(valid_bytes)
            else:
                with open(path, "r+b") as f:
                    f.truncate(valid_bytes)

    # -------------------------------------------------------------------- gc

    def flush(self) -> None:
        """Flush + fsync the open segment."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())

    def gc(self, durable_decree: int) -> int:
        """Drop whole segments strictly older than the segment holding
        durable_decree+1. -> segments dropped."""
        with self._lock:
            dropped = 0
            while len(self._segments) > 1 and \
                    self._segments[1] <= durable_decree + 1:
                start = self._segments.pop(0)
                try:
                    os.unlink(os.path.join(self.dir, f"log.{start}"))
                except OSError:
                    pass
                dropped += 1
            return dropped

    def reset(self) -> None:
        """Wipe everything (a learner re-seeded from a checkpoint)."""
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None
            for start in self._segments:
                try:
                    os.unlink(os.path.join(self.dir, f"log.{start}"))
                except OSError:
                    pass
            self._segments = []
            self.last_decree = 0

    def close(self) -> None:
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None

    # ---------------------------------------------------------------- helpers

    def _scan_segments(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("log.") and name[4:].isdigit():
                out.append(int(name[4:]))
        return sorted(out)

    def _tail_decree(self) -> int:
        last = 0
        for m in self.replay(0):
            last = max(last, m.decree)
        return last
