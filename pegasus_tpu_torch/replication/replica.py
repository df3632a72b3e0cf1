"""PacificA replica: prepare/ack/commit 2PC over the mutation log + engine.

Port of pegasus_tpu/replication/replica.py (the rDSN replication core;
knobs config.ini:205-215). One primary serializes writes per partition;
each mutation gets a decree, appends to the private log, and is sent as a
prepare to every secondary; the primary commits (applies to the storage
engine through on_batched_write_window) once `quorum` replicas, itself
included, hold it in their logs. Commit points piggyback on later
prepares. Decree pipelining: mutations arriving while a prepare round is
in flight coalesce into the next round, so one prepare carries the
contiguous decree window [d1..dk], the plog lands the window as one group
append, secondaries append it in order and ack their highest contiguous
decree, and the engine applies the committed window in one batched call.
Invariants:

  - prepares apply in decree order; a secondary acks decree d only when
    its log holds every decree <= d;
  - committed(d) => d is in the logs of a quorum => after any crash the
    live replica with the highest (ballot, last_prepared) holds every
    committed mutation; failover promotes it and commits its whole
    prepare list;
  - a rejoining replica re-seeds as a learner: a checkpoint of the
    primary's engine plus its log tail (the streamed learn,
    replication/learn.py).

Engine replay-on-open closes the WAL gap: committed-but-unflushed
mutations re-apply from the plog before serving. The engine is the
port's LsmEngine, on the card by default (EngineOptions()): every
replica's merges and device lookups run there. A merge or lookup failure
fails that replica's write (ReplicaError) or its learn; it never moves a
replica onto the cpu backend. A learned engine primes its resident runs
right after the swap, so the learner serves device reads as its peers
do.

Duplication rides the commit path: every applied mutation, in decree
order and including each decree of a batched window, goes to
`commit_hooks` (a shipper's on_commit only enqueues, so nothing blocks
under the replica's lock); the stub keeps the primary's shippers in
`duplicators`; and gc_log holds the log at each live duplication's
confirmed decree, so a promoted primary can catch its shipper up from
its own log.
"""

import json
import os
import time
from dataclasses import dataclass

from ..base import consts
from ..engine.db import EngineOptions
from ..engine.replica_service import WRITE_CODES
from ..engine.server_impl import PegasusServer
from ..rpc import codec
from ..runtime import events, lockrank
from ..runtime.job_trace import JOB_TRACER
from ..runtime.perf_counters import counters
from ..runtime.tasking import tracked_executor
from ..runtime.tracing import REQUEST_TRACER
from . import learn as learn_mod
from .mutation_log import LogMutation, MutationLog


def _parallel_prepare() -> bool:
    """PEGASUS_PARALLEL_PREPARE=1 fans prepares out concurrently (commit
    latency max(peer RTT) instead of the sum); the default is
    sequential."""
    return os.environ.get("PEGASUS_PARALLEL_PREPARE", "0") == "1"


INACTIVE = "INACTIVE"
PRIMARY = "PRIMARY"
SECONDARY = "SECONDARY"
LEARNER = "POTENTIAL_SECONDARY"
ERROR = "ERROR"


class ReplicaError(Exception):
    pass


class PrepareRejected(ReplicaError):
    def __init__(self, reason, last_prepared=0):
        super().__init__(reason)
        self.reason = reason
        self.last_prepared = last_prepared


@dataclass
class GroupView:
    """What the controller (the meta server's stand-in) tells members."""

    ballot: int
    primary: str
    secondaries: list


class _WriteSlot:
    __slots__ = ("code", "req", "resp", "err", "done")

    def __init__(self, code, req):
        self.code = code
        self.req = req
        self.resp = None
        self.err = None
        self.done = False


class Replica:
    """One partition replica. `peers` is a callable transport:
    peers(name) -> a Replica-like object; raises ConnectionError for a
    dead node."""

    def __init__(self, name: str, path: str, app_id: int = 1, pidx: int = 0,
                 options: EngineOptions = None, peers=None,
                 quorum: int = 2, fsync: bool = False, cluster_id: int = 0):
        self.name = name
        self.path = path
        self.app_id = app_id
        self.pidx = pidx
        self.cluster_id = cluster_id
        self.app_name = ""       # set by the replica stub at open
        self.partition_count = 0
        self.commit_hooks = []   # fn(LogMutation) after commit (duplication)
        self.duplicators = {}    # dupid -> MutationDuplicator (stub-managed)
        self.quorum = quorum
        self.peers = peers or (lambda n: (_ for _ in ()).throw(
            ConnectionError(n)))
        self._lock = lockrank.named_rlock("replica.lock")
        self.status = INACTIVE  #: guarded_by self._lock
        self.ballot = 0         #: guarded_by self._lock
        self.view = None        #: guarded_by self._lock
        # a streamed learn stages blocks with self._lock released:
        # prepares arriving meanwhile are rejected (the primary counts a
        # missing ack and catches this replica up after the swap)
        self._learning = False  #: guarded_by self._lock
        # primary-side learn pins: learn_id -> pin record. While pinned,
        # plog GC floors at the pinned checkpoint decree and the engine
        # holds the checkpoint out of its own GC. A leaf lock.
        self._learn_lock = lockrank.named_lock("replica.learn_pins")
        self._learn_pins = {}   #: guarded_by self._learn_lock
        self._learn_next_id = 0  #: guarded_by self._learn_lock
        # one learn at a time on the learner side (the transfer runs with
        # self._lock released)
        self._learn_serial = lockrank.named_lock("replica.learn_serial")
        self.server = PegasusServer(os.path.join(path, "data"), app_id=app_id,
                                    pidx=pidx, options=options, server=name,
                                    cluster_id=cluster_id)
        # on-disk corruption callout, kept here because a learn replaces
        # the engine and the new one must keep reporting
        self.corruption_hook = None
        self.plog = MutationLog(os.path.join(path, "plog"), fsync=fsync)
        # decree -> LogMutation (prepared, not applied)
        self._uncommitted = {}   #: guarded_by self._lock
        # primary side: secondaries that missed part of a prepare round
        # (rejected while learning, or unreachable); catch_up_lagging
        # brings them to the commit point when no later write would
        self._lagging = set()   #: guarded_by self._lock
        self._batch_cv = lockrank.named_condition("replica.batch")
        self._batch_pending = []  #: guarded_by self._batch_cv
        self._batch_leader_active = False  #: guarded_by self._batch_cv
        self.last_committed = self.server.engine.last_committed_decree()  #: guarded_by self._lock
        self.last_prepared = self.last_committed  #: guarded_by self._lock
        self._prep_pool = None
        pfx = f"replica.{app_id}.{pidx}."
        self._c_inflight = counters.number(pfx + "inflight")
        self._c_backlog = counters.number(pfx + "backlog")
        self._c_committed = counters.number(pfx + "committed_decree")
        self._c_applied = counters.number(pfx + "applied_decree")
        self._c_gap = counters.number(pfx + "secondary_gap_max")
        cpfx = f"engine.compact.{app_id}.{pidx}."
        self._c_debt_l0 = counters.number(cpfx + "l0_files")
        self._c_debt_bytes = counters.number(cpfx + "debt_bytes")
        self._c_debt_pending = counters.number(cpfx + "pending_installs")
        self._recover_from_log()

    def _prepare_pool(self):
        if self._prep_pool is None:
            self._prep_pool = tracked_executor(
                4, thread_name_prefix=f"prep-{self.name}")
        return self._prep_pool

    def set_corruption_hook(self, fn) -> None:
        """Install the corruption callout on this replica and its current
        engine (a learn's new engine inherits it)."""
        self.corruption_hook = fn
        self.server.engine.corruption_hook = fn

    # ----------------------------------------------------------- recovery

    def _recover_from_log(self):
        """Re-stage every logged mutation after the engine's committed
        point. They stay uncommitted until a view says our role (a new
        primary commits them all; a learner discards and re-seeds)."""
        for m in self.plog.replay(0):
            if m.decree > self.last_committed:
                self._uncommitted[m.decree] = m
                self.last_prepared = max(self.last_prepared, m.decree)
            self.ballot = max(self.ballot, m.ballot)

    # --------------------------------------------------------------- views

    def assume_view(self, view: GroupView):
        """A controller-installed configuration."""
        with self._lock:
            old = self.view
            self.view = view
            self.ballot = max(self.ballot, view.ballot)
            if view.primary == self.name:
                self.status = PRIMARY
                # PacificA failover rule: commit the entire prepare list
                self._apply_up_to(self.last_prepared)
                # a secondary new to the view (a learner that joined after
                # the writes it missed) gets the commit point pushed
                # (catch_up_lagging), not only with the next write
                known = set(old.secondaries) if old is not None \
                    and old.primary == self.name else set()
                self._lagging.update(set(view.secondaries) - known)
            elif self.name in view.secondaries:
                self.status = SECONDARY

    # -------------------------------------------------------------- primary

    def client_write(self, code: str, req, now: int = None):
        """The write path: 2PC from the primary. Every mutation gets its
        own decree; mutations arriving while a round is in flight
        coalesce into the next round's window."""
        slot = _WriteSlot(code, req)
        with self._batch_cv:
            self._batch_pending.append(slot)
        while True:
            with self._batch_cv:
                if slot.done:
                    break
                if self._batch_leader_active:
                    # notify-driven handoff; the timeout is a bound
                    self._batch_cv.wait(0.5)
                    continue
                self._batch_leader_active = True
                batch = self._batch_pending
                self._batch_pending = []
            # this thread leads one window commit (outside the cv, so
            # arriving writers queue for the next window)
            try:
                with self._lock:
                    self._commit_window(batch, now=now)
            except Exception as e:  # every waiter must see the failure
                for s in batch:
                    if s.err is None and s.resp is None:
                        s.err = e if isinstance(e, ReplicaError) \
                            else ReplicaError(f"group commit failed: {e!r}")
            finally:
                with self._batch_cv:
                    self._batch_leader_active = False
                    for s in batch:
                        s.done = True
                    self._batch_cv.notify_all()
        if slot.err is not None:
            raise slot.err
        return slot.resp

    def _commit_window(self, slots, now=None):  #: requires self._lock
        """One contiguous decree window for `slots` (one decree each).
        Fills each slot's resp/err in place."""
        if self.status != PRIMARY:
            raise ReplicaError(f"{self.name} is not primary")
        d0 = self.last_prepared + 1
        ts = int(time.time() * 1e6)
        ms = [LogMutation(decree=d0 + i, ballot=self.ballot, timestamp_us=ts,
                          codes=[s.code], bodies=[codec.encode(s.req)])
              for i, s in enumerate(slots)]
        dk = ms[-1].decree
        t0 = time.perf_counter()
        with REQUEST_TRACER.span("replica.prepare", decree=dk,
                                 batch=len(ms)):
            self.plog.append_window(ms)
            self.last_prepared = dk
            for m in ms:
                self._uncommitted[m.decree] = m
            secs = list(self.view.secondaries)
            if len(secs) > 1 and _parallel_prepare():
                # wait for all, so per-peer prepare order stays
                # monotonic; the trace context is thread-local, so each
                # worker adopts it and the peers' prepare spans (and the
                # trace_id on the wire) survive the pool hop
                ctx = REQUEST_TRACER.current()

                def send(s):
                    with REQUEST_TRACER.adopt(ctx):
                        return self._send_prepare_window(s, ms)

                futs = [self._prepare_pool().submit(send, s) for s in secs]
                peer_lps = [f.result() for f in futs]
            else:
                peer_lps = [self._send_prepare_window(s, ms) for s in secs]
        counters.percentile("replica.prepare_latency_us").set(
            int((time.perf_counter() - t0) * 1e6))
        self._export_gauges()
        # commit point: the highest d in the window such that a quorum
        # (us included) holds every decree <= d
        acks = [lp for lp in peer_lps if lp is not None]
        self._c_gap.set(max((max(0, dk - lp) for lp in acks), default=0))
        for s, lp in zip(secs, peer_lps):
            if lp is None or lp < dk:
                self._lagging.add(s)
            else:
                self._lagging.discard(s)
        commit_d = d0 - 1
        for d in range(d0, dk + 1):
            if 1 + sum(1 for lp in acks if lp >= d) >= self.quorum:
                commit_d = d
            else:
                break
        if commit_d < d0:
            # cannot commit; left prepared (a later view change decides)
            raise ReplicaError(
                f"quorum lost: {1 + len(acks)}/{self.quorum} "
                f"for decrees [{d0}..{dk}]")
        t1 = time.perf_counter()
        with REQUEST_TRACER.span("replica.commit", decree=commit_d):
            resps = self._apply_up_to(commit_d, now=now)
        counters.percentile("replica.commit_latency_us").set(
            int((time.perf_counter() - t1) * 1e6))
        self._export_gauges()
        for i, s in enumerate(slots):
            d = d0 + i
            if d <= commit_d:
                rl = resps.get(d)
                s.resp = rl[0] if rl else None
            else:
                s.err = ReplicaError(
                    f"quorum lost: decree {d} prepared but not committed")

    def _export_gauges(self):  #: requires self._lock
        """Slots queued for the next window (inflight), prepared but
        uncommitted decrees (backlog), and the committed/applied pair."""
        self._c_inflight.set(len(self._batch_pending))
        self._c_backlog.set(len(self._uncommitted))
        self._c_committed.set(self.last_committed)
        self._c_applied.set(self.server.engine.last_committed_decree())

    def compact_debt(self) -> dict:
        """Per-partition compaction-debt snapshot: one engine fold feeding
        the `engine.compact.<app>.<pidx>.*` gauges."""
        debt = self.server.engine.compaction_debt()
        self._c_debt_l0.set(debt["l0_files"])
        self._c_debt_bytes.set(debt["debt_bytes"])
        self._c_debt_pending.set(debt["pending_installs"])
        return debt

    def _send_prepare_window(self, peer_name: str, ms: list):
        """One windowed prepare to a peer. -> the peer's highest
        contiguous prepared decree, or None for a dead/rejecting peer."""
        try:
            peer = self.peers(peer_name)
            try:
                return self._peer_prepare(peer, ms)
            except PrepareRejected as rej:
                if rej.reason == "gap":
                    return self._catch_up_peer(peer, rej.last_prepared, ms)
                return None
        except ConnectionError:
            return None

    def _peer_prepare(self, peer, ms: list):
        """One windowed prepare round. -> the acked decree."""
        return peer.on_prepare_batch(self.ballot, ms, self.last_committed)

    def _catch_up_peer(self, peer, peer_prepared: int, ms: list):
        """Stream the missing decrees from our log as chunked windows,
        then retry the current window (none for a commit-point
        broadcast). -> the acked decree or None."""
        try:
            backlog = {}
            for lm in self.plog.replay(peer_prepared):
                if not ms or lm.decree < ms[0].decree:
                    backlog[lm.decree] = lm  # dedup, newest copy wins
            chunks = [ms]
            ordered = [backlog[d] for d in sorted(backlog)]
            if ordered:
                chunks = [ordered[i:i + 64]
                          for i in range(0, len(ordered), 64)] + [ms]
            lp = None
            for chunk in chunks:
                lp = self._peer_prepare(peer, chunk)
            return lp
        except (PrepareRejected, ConnectionError):
            return None

    # ------------------------------------------------------------ secondary

    def on_prepare_batch(self, ballot: int, ms: list, committed_decree: int):
        """Windowed prepare: stage a contiguous decree window with one
        plog group append and ack the highest contiguous prepared decree.
        An empty window is a pure commit-point broadcast."""
        with REQUEST_TRACER.span("replica.on_prepare",
                                 decree=ms[-1].decree if ms
                                 else committed_decree,
                                 batch=len(ms)), self._lock:
            if self._learning:
                # mid-learn the staged state is about to replace this
                # replica wholesale: the primary counts a missing ack and
                # catches up after the swap
                raise PrepareRejected("learning", self.last_prepared)
            if ballot < self.ballot:
                raise PrepareRejected("stale_ballot", self.last_prepared)
            self.ballot = ballot
            fresh, gap = [], False
            for m in ms:
                if m.decree <= self.last_committed:
                    continue  # already committed: drop
                if m.decree <= self.last_prepared:
                    # duplicate (catch-up overlap): keep newest copy staged
                    self._uncommitted.setdefault(m.decree, m)
                elif m.decree == self.last_prepared + len(fresh) + 1:
                    fresh.append(m)
                elif m.decree <= self.last_prepared + len(fresh):
                    pass  # duplicates a decree already in this window
                else:
                    gap = True
                    break
            if fresh:
                # durability before ack: the window is in the log first
                self.plog.append_window(fresh)
                for m in fresh:
                    self._uncommitted[m.decree] = m
                self.last_prepared = fresh[-1].decree
            self._apply_up_to(min(committed_decree, self.last_prepared))
            self._export_gauges()
            # an empty window past what this replica holds: it joined
            # after the decrees it lacks were sent, and only a catch-up
            # brings them
            if gap or not ms and committed_decree > self.last_prepared:
                raise PrepareRejected("gap", self.last_prepared)
            return self.last_prepared

    def broadcast_commit_point(self) -> int:
        """Push the current commit point to every secondary as an empty
        prepare window, so decrees they hold prepared apply now instead
        of on the next write. -> the number of peers that acked."""
        with self._lock:
            if self.status != PRIMARY or self.view is None:
                return 0
            secs = list(self.view.secondaries)
            ballot, committed = self.ballot, self.last_committed
        return sum(self._push_commit_point(s, ballot, committed)
                   for s in secs)

    def catch_up_lagging(self) -> int:
        """Push the commit point to the secondaries that missed part of a
        prepare round, catching each up from this log: a learner whose
        learn ended after the partition's last write would otherwise stay
        behind the commit point (and could be promoted so). Peers that
        still do not ack stay marked. -> the number caught up."""
        with self._lock:
            if self.status != PRIMARY or self.view is None:
                self._lagging.clear()
                return 0
            self._lagging &= set(self.view.secondaries)
            lagging = list(self._lagging)
            ballot, committed = self.ballot, self.last_committed
        done = [s for s in lagging
                if self._push_commit_point(s, ballot, committed)]
        with self._lock:
            self._lagging.difference_update(done)
        return len(done)

    def _push_commit_point(self, name: str, ballot: int,
                           committed: int) -> bool:
        """One empty prepare window to a secondary; one that holds less
        than the commit point answers `gap` and is streamed the rest.
        -> whether it acked."""
        try:
            peer = self.peers(name)
            try:
                peer.on_prepare_batch(ballot, [], committed)
            except PrepareRejected as rej:
                return rej.reason == "gap" and self._catch_up_peer(
                    peer, rej.last_prepared, []) is not None
            return True
        except ConnectionError:
            return False

    def on_prepare(self, ballot: int, m: LogMutation, committed_decree: int):
        with REQUEST_TRACER.span("replica.on_prepare", decree=m.decree), \
                self._lock:
            if self._learning:
                raise PrepareRejected("learning", self.last_prepared)
            if ballot < self.ballot:
                raise PrepareRejected("stale_ballot", self.last_prepared)
            self.ballot = ballot
            if m.decree <= self.last_committed:
                pass  # already committed: staging it would leak
            elif m.decree <= self.last_prepared:
                self._uncommitted.setdefault(m.decree, m)
            elif m.decree == self.last_prepared + 1:
                self.plog.append(m)
                self.last_prepared = m.decree
                self._uncommitted[m.decree] = m
            else:
                raise PrepareRejected("gap", self.last_prepared)
            self._apply_up_to(min(committed_decree, self.last_prepared))

    # ---------------------------------------------------------------- apply

    def _apply_up_to(self, decree: int, now: int = None):  #: requires self._lock
        """Commit staged mutations in order through the engine, the whole
        contiguous window in one batched call. -> {decree: responses}."""
        if self.last_committed >= decree:
            return {}
        window = []
        for d in range(self.last_committed + 1, decree + 1):
            m = self._uncommitted.pop(d, None)
            if m is None:
                raise ReplicaError(f"{self.name}: commit gap at decree {d}")
            reqs = []
            for code, body in zip(m.codes, m.bodies):
                req_cls, _ = WRITE_CODES[code]
                reqs.append((code, codec.decode(req_cls, body)))
            window.append((d, m.timestamp_us, reqs, m))
        try:
            resps = self.server.on_batched_write_window(
                [w[:3] for w in window], now=now)
        except Exception:
            # a mid-window engine failure leaves the engine at its own
            # committed point: re-stage what was not applied, so a later
            # view change or retry can still commit it, and fire the
            # commit hooks for what was applied (a shipper advances past
            # this window on the next commit, so a decree skipped here
            # would never ship)
            applied = self.server.engine.last_committed_decree()
            for d, _, _, m in window:
                if d > applied:
                    self._uncommitted[d] = m
                else:
                    for hook in self.commit_hooks:
                        hook(m)
            self.last_committed = max(self.last_committed, applied)
            raise
        self.last_committed = decree
        for _, _, _, m in window:
            for hook in self.commit_hooks:
                hook(m)
        return resps

    # --------------------------------------------------------------- learner

    def learn_from(self, primary):
        """Re-seed from the primary: checkpoint copy + log tail.
        `primary` exposes prepare_learn_state (the streamed learn) or
        only fetch_learn_state (the monolithic one)."""
        learning = counters.number(
            f"replica.{self.app_id}.{self.pidx}.learning")
        learning.set(1)
        events.emit("learn.start", gpid=f"{self.app_id}.{self.pidx}")
        t0 = time.monotonic()
        ok = False
        try:
            with self._learn_serial:
                with self._lock:
                    self.status = LEARNER
                    self._learning = True
                    self._uncommitted.clear()
                try:
                    if hasattr(primary, "prepare_learn_state"):
                        self._learn_streamed(primary)
                    else:
                        self._learn_monolithic(primary)
                finally:
                    with self._lock:
                        self._learning = False
            ok = True
        finally:
            learning.set(0)
            events.emit("learn.finish", severity="info" if ok else "error",
                        gpid=f"{self.app_id}.{self.pidx}", ok=ok,
                        dur_s=round(time.monotonic() - t0, 3),
                        committed=self.last_committed)
            with self._lock:
                self._export_gauges()

    def _learn_streamed(self, primary):
        """Block-shipped learn: manifest-diff handshake, chunked delta
        streaming into learn_ckpt/ with both locks released (the primary
        serves pinned immutable files, this replica rejects prepares),
        the decree-anchored digest proof of the staged state, then a
        short swap critical section. Each learn is ONE traced job:
        prepare, fetch, tail, digest proof and swap are its hops, and the
        job id rides the prepare RPC, so the serving primary attributes
        its checkpoint pin to this learn's timeline."""
        with JOB_TRACER.job("learn", gpid=f"{self.app_id}.{self.pidx}",
                            learner=self.name):
            self._learn_streamed_traced(primary)

    def _learn_streamed_traced(self, primary):
        import shutil

        t0 = time.perf_counter()
        ckpt_dir = os.path.join(self.path, "learn_ckpt")
        data_dir = os.path.join(self.path, "data")
        # the delta handshake: blocks staged by an interrupted ship plus
        # the live engine's files (the live manifest doubles as
        # stage_blocks' link-reuse index)
        delta_on = learn_mod.delta_enabled()
        live = learn_mod.dir_manifest(data_dir) if delta_on else []
        have = (learn_mod.dir_manifest(ckpt_dir) + live) if delta_on else []
        with JOB_TRACER.hop("learn.prepare", have=len(have)) as jh:
            st = primary.prepare_learn_state(have=have, delta=delta_on)
            jh["blocks"] = len(st["blocks"])
            jh["missing"] = len(st["missing"])
        try:
            with JOB_TRACER.hop("learn.fetch") as jh:
                stats = learn_mod.stage_blocks(
                    primary, st, ckpt_dir, delta=delta_on,
                    reuse={e["digest"]: os.path.join(data_dir, e["name"])
                           for e in live})
                jh.update({k: stats[k] for k in
                           ("fetched", "bytes", "skipped", "resumed")})
            with JOB_TRACER.hop("learn.tail"):
                tail_state = primary.fetch_learn_tail(st["learn_id"])
        finally:
            primary.finish_learn(st["learn_id"])
        verify = ""
        if st.get("digest"):
            # the shipped state proves itself before it may serve: a delta
            # learn through the fold over the blocks it verified, a learn
            # that reused nothing through the full rescan
            with JOB_TRACER.hop("learn.digest_proof") as jh:
                if learn_mod.incremental_digest_enabled() \
                        and stats["skipped"] + stats["resumed"] > 0 \
                        and stats.get("fold") \
                        and stats["fold"] == learn_mod.manifest_fold(
                            st["blocks"]):
                    verify = "incremental"
                    counters.rate(
                        "learn.verify.incremental_count").increment()
                else:
                    verify = "rescan"
                    counters.rate("learn.verify.rescan_count").increment()
                    from ..engine.db import LsmEngine

                    ver = LsmEngine(ckpt_dir, EngineOptions(
                        backend="cpu", pidx=self.pidx))
                    try:
                        d = ver.state_digest(now=st["digest_now"],
                                             pmask=st["digest_pmask"])
                    finally:
                        ver.close()
                    if d["digest"] != st["digest"]:
                        raise ReplicaError(
                            f"{self.name}: shipped state digest mismatch "
                            f"at checkpoint decree {st['ckpt_decree']}: "
                            f"{d['digest']} != primary {st['digest']}")
                jh["mode"] = verify
        with JOB_TRACER.hop("learn.swap") as jh:
            replayed = self._swap_learned_state(ckpt_dir, tail_state)
            jh["replayed"] = replayed
        # staged blocks are hard-linked into data/ now; keeping them would
        # feed stale names into the next learn's have-set
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        counters.percentile("learn.ship.duration_us").set(
            int((time.perf_counter() - t0) * 1e6))
        events.emit("learn.ship", gpid=f"{self.app_id}.{self.pidx}",
                    decree=st["ckpt_decree"], fetched=stats["fetched"],
                    bytes=stats["bytes"], delta_skipped=stats["skipped"],
                    resumed=stats["resumed"], replayed=replayed,
                    verify=verify)

    def _learn_monolithic(self, primary):
        """Whole-state learn (a peer without the block-ship surface): the
        transfer runs with this replica's lock released, only the swap is
        a critical section."""
        state = primary.fetch_learn_state()
        ckpt_dir = os.path.join(self.path, "learn_ckpt")
        if os.path.exists(ckpt_dir):
            import shutil

            shutil.rmtree(ckpt_dir)
        os.makedirs(ckpt_dir)
        nbytes = 0
        for fname, blob in state["files"]:
            with open(os.path.join(ckpt_dir, fname), "wb") as f:
                f.write(blob)
            nbytes += len(blob)
        counters.rate("learn.ship.blocks").increment(len(state["files"]))
        counters.rate("learn.ship.bytes").increment(nbytes)
        self._swap_learned_state(ckpt_dir, state)

    def _swap_learned_state(self, ckpt_dir: str, tail_state: dict) -> int:
        """The learn's only critical section: swap the staged checkpoint
        in as the serving engine (the old one releases its resident runs
        in close()), reset the plog, stage + apply the log tail above the
        checkpoint decree. Then, on the cuda backend, prime the new
        engine's runs. -> tail mutations replayed."""
        replayed = 0
        with self._lock:
            opts = self.server.engine.opts
            self.server.close()
            from ..engine.db import LsmEngine

            engine = LsmEngine.apply_checkpoint(
                ckpt_dir, os.path.join(self.path, "data"), opts)
            engine.close()  # PegasusServer opens its own on the same dir
            self.server = PegasusServer(os.path.join(self.path, "data"),
                                        app_id=self.app_id, pidx=self.pidx,
                                        options=opts, server=self.name,
                                        cluster_id=self.cluster_id)
            self.server.engine.corruption_hook = self.corruption_hook
            self.plog.reset()
            self.last_committed = self.server.engine.last_committed_decree()
            self.last_prepared = self.last_committed
            # replay only the log tail beyond the checkpoint decree; what
            # lies at or below it (the primary's duplication floor reaching
            # back) is logged, not applied: a promoted shipper catches up
            # from it
            ckpt_decree = self.last_prepared
            self.plog.append_window([m for m in tail_state["tail"]
                                     if m.decree <= ckpt_decree])
            for m in tail_state["tail"]:
                if m.decree <= self.last_prepared:
                    continue
                self.plog.append(m)
                self.last_prepared = m.decree
                self._uncommitted[m.decree] = m
                replayed += 1
            self._apply_up_to(min(tail_state["last_committed"],
                                  self.last_prepared))
            self.ballot = max(self.ballot, tail_state["ballot"])
            self.status = SECONDARY
            engine = self.server.engine
        if engine.opts.backend == "cuda":
            engine.prime_resident_runs()
        counters.rate("learn.replay.mutations").increment(replayed)
        return replayed

    # ------------------------------------------------------ learn: primary

    def prepare_learn_state(self, have=None, delta=None) -> dict:
        """Manifest-diff handshake, primary side: pin an immutable
        checkpoint, diff its block manifest against the learner's `have`
        set, and return the missing blocks' metadata with the
        checkpoint's decree-anchored digest. The replica lock is held
        only for the watermark snapshot."""
        eng = self.server.engine
        ttl = learn_mod.pin_ttl_s()
        with eng.checkpoint_lock:
            # flush=False: snapshot the durable state only; the unflushed
            # window rides the log tail
            decree = eng.sync_checkpoint(flush=False)
            ckpt = eng.get_checkpoint_dir(decree)
            token = eng.pin_checkpoint(decree, ttl_s=ttl)
        try:
            manifest = learn_mod.dir_manifest(ckpt)
            digest = (eng.checkpoint_digest(decree)
                      if learn_mod.verify_enabled() else {})
        except BaseException:
            eng.unpin_checkpoint(decree, token)
            raise
        with self._learn_lock:
            self._learn_next_id += 1
            learn_id = self._learn_next_id
            self._learn_pins[learn_id] = {
                "decree": decree, "dir": ckpt, "token": token,
                "expires": time.monotonic() + ttl}
        delta_on = learn_mod.delta_enabled() if delta is None else bool(delta)
        have_set = {(e["name"], e["digest"])
                    for e in (have or [])} if delta_on else set()
        missing = [e["name"] for e in manifest
                   if (e["name"], e["digest"]) not in have_set]
        with self._lock:
            ballot, committed = self.ballot, self.last_committed
        return {"learn_id": learn_id, "ckpt_decree": decree,
                "ballot": ballot, "last_committed": committed,
                "blocks": manifest, "missing": missing,
                "digest": digest.get("digest", ""),
                "digest_now": digest.get("now", 0),
                "digest_pmask": digest.get("pmask", 0)}

    def _learn_pin(self, learn_id: int, renew: bool = True) -> dict:
        """Resolve (and lease-renew) an active learn pin; an expired or
        unknown pin fails the fetch loudly."""
        now = time.monotonic()
        ttl = learn_mod.pin_ttl_s()
        snap = None
        with self._learn_lock:
            pin = self._learn_pins.get(learn_id)
            if pin is not None and now < pin["expires"]:
                if renew:
                    pin["expires"] = now + ttl
                snap = dict(pin)
        if snap is None:
            raise ReplicaError(
                f"{self.name}: learn {learn_id} expired/unknown")
        if renew:
            self.server.engine.renew_checkpoint_pin(snap["decree"],
                                                    snap["token"], ttl)
        return snap

    def fetch_learn_block(self, learn_id: int, name: str, offset: int,
                          length: int) -> dict:
        """One chunk of one pinned checkpoint block, lock-free: pinned
        files are immutable and held out of GC."""
        import zlib

        from ..runtime.fail_points import inject

        inject("learn.ship")  # chaos seam: a mid-ship abort on the primary
        pin = self._learn_pin(learn_id)
        path = os.path.join(pin["dir"], os.path.basename(name))
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        return {"data": data, "crc": zlib.crc32(data),
                "total": os.path.getsize(path)}

    def fetch_learn_chunks(self, learn_id: int, reqs) -> list:
        """An in-process chunk wave."""
        return [self.fetch_learn_block(learn_id, name, off, ln)
                for (name, off, ln) in reqs]

    def fetch_learn_tail(self, learn_id: int) -> dict:
        """The log tail above the pinned checkpoint decree + watermarks,
        reaching back to the duplication floor where a live duplication
        still needs older decrees shipped: the learner keeps them in its
        log (unapplied), so promoted it can catch its shippers up. The
        replay runs lock-free (gc_log's pin and dup floors hold the
        segments)."""
        pin = self._learn_pin(learn_id)
        with self._lock:
            ballot, committed = self.ballot, self.last_committed
        start = pin["decree"]
        dup_floor = self._dup_log_floor()
        if dup_floor is not None:
            start = min(start, dup_floor)
        tail = list(self.plog.replay(start))
        return {"tail": tail, "last_committed": committed, "ballot": ballot}

    def finish_learn(self, learn_id: int) -> None:
        """Release the learn pin. Idempotent; expiry covers a dead
        learner."""
        with self._learn_lock:
            pin = self._learn_pins.pop(learn_id, None)
        if pin is not None:
            self.server.engine.unpin_checkpoint(pin["decree"], pin["token"])

    def _live_learn_pin_floor(self):
        """The lowest pinned checkpoint decree (None without pins): the
        plog GC floor while learns are in flight; expired pins reaped."""
        now = time.monotonic()
        dead = []
        with self._learn_lock:
            for lid, pin in list(self._learn_pins.items()):
                if now >= pin["expires"]:
                    dead.append(self._learn_pins.pop(lid))
            floor = min((p["decree"] for p in self._learn_pins.values()),
                        default=None)
        for pin in dead:
            self.server.engine.unpin_checkpoint(pin["decree"], pin["token"])
        return floor

    def learn_state(self) -> dict:
        """Learner-side learn snapshot (the learn-status command)."""
        with self._lock:
            return {"learning": self._learning, "status": self.status}

    def learn_pins(self) -> list:
        """Active primary-side learn pins."""
        now = time.monotonic()
        with self._learn_lock:
            return [{"learn_id": lid, "decree": p["decree"],
                     "expires_in_s": round(max(0.0, p["expires"] - now), 1)}
                    for lid, p in self._learn_pins.items()]

    def fetch_learn_state(self) -> dict:
        """The monolithic learn state, pin-then-release: every file read
        runs with no replica lock held."""
        st = self.prepare_learn_state(have=(), delta=False)
        lid = st["learn_id"]
        try:
            pin = self._learn_pin(lid, renew=False)
            files = []
            for e in st["blocks"]:
                with open(os.path.join(pin["dir"], e["name"]), "rb") as f:
                    files.append((e["name"], f.read()))
            tail_state = self.fetch_learn_tail(lid)
            return {"files": files, "tail": tail_state["tail"],
                    "last_committed": tail_state["last_committed"],
                    "ballot": tail_state["ballot"]}
        finally:
            self.finish_learn(lid)

    # ------------------------------------------------------------- plumbing

    def gc_log(self, flush: bool = False):
        """Drop log segments the durable SSTs cover, never past a live
        learn pin nor a live duplication's confirmed decree: a restarted
        or promoted shipper must be able to catch_up() from this log.
        flush=True forces the memtable down first."""
        if flush:
            self.server.engine.flush()
        floor = self.server.engine.last_durable_decree()
        for f in (self._live_learn_pin_floor(), self._dup_log_floor()):
            if f is not None:
                floor = min(floor, f)
        self.plog.gc(floor)

    def _dup_log_floor(self):
        """The lowest decree a live duplication may still need shipped
        (None without one): per dup entry, the meta-confirmed decree the
        env carries, on a primary too. A replica promoted after holding
        this log as a secondary, or after learning its tail from it,
        builds its shipper at the meta-confirmed decree and catches up
        from its own log, so every member keeps the log back to there
        (the reference's primary kept it only back to its own shipper's
        progress, which runs ahead of the meta). The meta re-pushes the
        entries, so the floor advances on a stable cluster."""
        entries = {e["dupid"]: e for e in self._dup_env_entries()
                   if e.get("status") in ("init", "start", "pause")}
        floors = [int(e.get("confirmed", {}).get(str(self.pidx), 0))
                  for e in entries.values()]
        for dupid, d in dict(self.duplicators).items():
            if dupid not in entries:  # shipper ahead of the env snapshot
                floors.append(d.last_shipped_decree)
        return min(floors, default=None)

    def _dup_env_entries(self) -> list:
        try:
            return json.loads(
                self.server.app_envs.get(consts.ENV_DUPLICATION_KEY, "[]"))
        except ValueError:
            return []

    def close(self):
        for dupid, d in self.duplicators.items():
            d.stop()
            counters.remove(f"dup.lag.{self.app_id}.{self.pidx}.{dupid}")
        self.duplicators.clear()
        # a closed replica's frozen gauges must not keep feeding readers
        for name in ("inflight", "backlog", "committed_decree",
                     "applied_decree", "secondary_gap_max", "learning"):
            counters.remove(f"replica.{self.app_id}.{self.pidx}.{name}")
        for name in ("l0_files", "debt_bytes", "pending_installs"):
            counters.remove(
                f"engine.compact.{self.app_id}.{self.pidx}.{name}")
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=False)
            self._prep_pool = None
        self.plog.close()
        self.server.close()
