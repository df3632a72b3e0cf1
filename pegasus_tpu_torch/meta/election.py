"""Leader election + lease for the meta-server replica set.

Port of pegasus_tpu/meta/election.py, whole: the same lease file
(holder address and epoch) over the same shared state directory, so a
port meta and a reference meta can share one election.

The reference runs THREE meta servers whose election and state both live
in ZooKeeper: `meta_state_service_type = meta_state_service_zookeeper` +
`distributed_lock_service_zookeeper` (reference
src/server/config.ini:160-167, :380-383) and the onebox boots
META_COUNT=3 (run.sh:509). This build's analogue keeps both halves on
SHARED DURABLE STORAGE — a directory every meta can reach (the onebox
shares the local filesystem; multi-host deployments mount it via NFS or
the block-service providers, exactly the role ZK plays for the
reference):

  - the LEASE FILE is the distributed lock: its content names the
    leader and carries a monotonic EPOCH (fencing token), its mtime is
    the heartbeat. A leader refreshes it every lease/3; anyone finding
    it older than the lease takes over with epoch+1 via an atomic
    replace + settle-and-reread round that resolves concurrent
    takeovers (last writer wins, every racer re-reads after a settle
    delay, losers demote). The epoch fences stale self-believing
    leaders: a leader stalled past its lease (GIL pause, NFS hang) that
    wakes up and tries to persist re-verifies the lease first and
    refuses to clobber state written under a newer epoch
    (verify_for_persist / meta_server._persist_locked).
  - the shared state.json is the replicated meta state: every mutating
    DDL persists BEFORE acknowledging (meta_server handlers), and a new
    leader reloads it on takeover — so any write the old leader
    acknowledged is visible after its SIGKILL. That is the HA contract
    the reference's tests/test_process_kill.py::test_meta_leader_kill asserts.

Followers redirect every RPC except beacons with ERR_FORWARD_TO_PRIMARY;
clients/shell/replicas already fall through their meta list, so
redirection needs no routing table — the leader is whoever doesn't
refuse.
"""

import os
import threading
import time

from ..runtime.tasking import spawn_thread



class MetaElection:
    def __init__(self, lock_path: str, my_addr: str,
                 lease_seconds: float = 6.0, on_acquire=None,
                 on_demote=None, settle_seconds: float = None,
                 claim_floor=None):
        self.lock_path = lock_path
        self.my_addr = my_addr
        self.lease = lease_seconds
        self.on_acquire = on_acquire
        self.on_demote = on_demote
        # claim_floor() -> int: a durable lower bound for claim epochs (the
        # meta wires its state-file epoch here). Without it, a graceful
        # release that dropped the lease file would reset the epoch lineage
        # to 0 and every later persist would be fenced by the state file
        # forever.
        self.claim_floor = claim_floor or (lambda: 0)
        # long enough for a concurrent racer's replace to land, short
        # enough to keep failover well under the FD grace
        self.settle = (settle_seconds if settle_seconds is not None
                       else min(0.2, lease_seconds / 10))
        self._leader = False
        self.epoch = 0  # fencing token: the epoch we claimed under
        self._stop = threading.Event()
        self._started = False
        self._thread = spawn_thread(self._loop, daemon=True, start=False,
                                    name=f"meta-election:{my_addr}")

    # ------------------------------------------------------------- queries

    def is_leader(self) -> bool:
        return self._leader

    def leader(self):
        """Current lease holder per the lock file (None if no live lease);
        serves as the redirect hint in follower refusals."""
        holder, age, _ = self._read()
        if holder is None or age > self.lease:
            return None
        return holder

    def verify_for_persist(self) -> bool:
        """Re-read the lease immediately before a shared-state persist.
        True only if this meta still holds it; on loss, demote in place so
        the caller's skip and the next tick's callbacks agree."""
        holder, age, epoch = self._read()
        ok = holder == self.my_addr and age <= self.lease
        if not ok:
            self._set_leader(False)
        else:
            # a racer may have bumped the epoch and then crashed before we
            # noticed; never persist under an epoch older than the lease's
            self.epoch = max(self.epoch, epoch)
        return ok

    # ----------------------------------------------------------- lifecycle

    def start(self):
        self._tick()  # synchronous first round: a lone meta is leader
        self._started = True
        self._thread.start()  # by the time start() returns
        return self

    def stop(self):
        self._stop.set()
        if self._started:  # stop() before/after a failed start() must not
            self._thread.join(timeout=self.lease)  # join an unstarted thread
        if self._leader:
            # graceful release: clear the holder so the next leader does
            # not wait out the staleness window — but KEEP the epoch: the
            # lineage must stay monotonic across releases or the next
            # claimant would claim under an epoch the state file has
            # already passed and fence itself forever
            holder, _, epoch = self._read()
            if holder == self.my_addr:
                self.release_lease(max(epoch, self.epoch))
            self._set_leader(False)

    def release_lease(self, epoch: int = None):
        """Write an UNHELD lease carrying the epoch lineage forward."""
        tmp = f"{self.lock_path}.{self.my_addr.replace(':', '_')}.tmp"
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(f"\n{self.epoch if epoch is None else epoch}")
        os.replace(tmp, self.lock_path)

    # ------------------------------------------------------------ internals

    def _loop(self):
        while not self._stop.wait(self.lease / 3):
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 - a dead election thread
                # would freeze leadership forever; log and keep ticking
                print(f"[meta-election] {self.my_addr}: {e!r}", flush=True)

    def _tick(self):
        holder, age, epoch = self._read()
        if holder == self.my_addr and age <= self.lease:
            self.epoch = max(self.epoch, epoch)
            self._refresh()
            # re-read: our refresh and a racer's takeover can interleave
            holder, _, _ = self._read()
            self._set_leader(holder == self.my_addr)
        elif holder is None or age > self.lease:
            # holder == us with an EXPIRED lease (a stall outlived our own
            # lease) takes this branch too: resuming with a plain refresh
            # would keep the OLD epoch and could clobber a concurrent
            # claimant's epoch+1 lease inside the settle window: re-claim
            # like anyone else, with a bumped epoch
            self._try_claim(lease_epoch=epoch)
        else:
            self._set_leader(False)

    def _read(self):
        """-> (holder_addr | None, age_seconds, epoch)."""
        try:
            with open(self.lock_path) as f:
                lines = f.read().splitlines()
            holder = lines[0].strip() if lines else ""
            try:
                epoch = int(lines[1]) if len(lines) > 1 else 0
            except ValueError:
                epoch = 0
            age = time.time() - os.stat(self.lock_path).st_mtime
            return (holder or None), age, epoch
        except OSError:
            return None, float("inf"), 0

    def _refresh(self):
        self._write_lease()

    def _write_lease(self, epoch: int = None):
        if epoch is None:
            epoch = self.epoch
        tmp = f"{self.lock_path}.{self.my_addr.replace(':', '_')}.tmp"
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(f"{self.my_addr}\n{epoch}")
        os.replace(tmp, self.lock_path)

    def _try_claim(self, lease_epoch: int = 0):
        # a claim must exceed BOTH lineages: the lease file's (normal
        # succession) and the durable state's (survives lease-file loss)
        try:
            floor = int(self.claim_floor())
        except Exception:  # noqa: BLE001 - an unreadable floor must not
            floor = 0  # block election; the persist-side fence still holds
        epoch = max(lease_epoch, floor) + 1
        from ..runtime import events

        events.emit("meta.epoch_bump", meta=self.my_addr, epoch=epoch)
        self._write_lease(epoch)
        # settle-and-reread: concurrent claimants all replaced the file;
        # exactly one write landed last. Everyone re-reads after a settle
        # delay and only the survivor leads (with the epoch it wrote or a
        # racer's higher one).
        time.sleep(self.settle)
        holder, _, won_epoch = self._read()
        if holder == self.my_addr:
            self.epoch = max(epoch, won_epoch)
        self._set_leader(holder == self.my_addr)

    def _set_leader(self, value: bool):
        if value == self._leader:
            return
        self._leader = value
        from ..runtime import events

        events.emit("meta.election", severity="warn", meta=self.my_addr,
                    leader=value, epoch=self.epoch)
        cb = self.on_acquire if value else self.on_demote
        if cb is not None:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 - callback bugs must not
                print(f"[meta-election] {self.my_addr} callback: {e!r}",
                      flush=True)  # kill the election thread
