"""Replica-group controller: the meta server's reconfiguration role,
in-process.

Port of pegasus_tpu/replication/group.py, whole. Drives PacificA view
changes over a set of Replicas: promote the live replica with the
highest (ballot, last_prepared), which PacificA's quorum rule guarantees
holds every committed mutation; rebuild dead members as learners; and
re-install views. The kill tests run against exactly this surface.

The port's replicas default to EngineOptions(), the cuda backend on the
card; tests pass options_factory=lambda: EngineOptions(backend="cpu")
(or device="cpu").
"""

import os
import threading

from ..engine.db import EngineOptions
from .replica import ERROR, GroupView, Replica, ReplicaError


class ReplicaGroup:
    def __init__(self, root: str, n: int = 3, app_id: int = 1, pidx: int = 0,
                 options_factory=None, quorum: int = 2):
        self.root = root
        self.names = [f"r{i}" for i in range(n)]
        self.app_id = app_id
        self.pidx = pidx
        self.quorum = quorum
        self.options_factory = options_factory or EngineOptions
        self._lock = threading.RLock()
        self.alive = {}     # name -> Replica
        self.ballot = 0
        self.primary = None
        for name in self.names:
            self.alive[name] = self._open(name)
        self.elect()

    def _open(self, name: str) -> Replica:
        return Replica(name, os.path.join(self.root, name), self.app_id,
                       self.pidx, self.options_factory(), peers=self._peer,
                       quorum=self.quorum)

    def _peer(self, name: str):
        r = self.alive.get(name)
        if r is None:
            raise ConnectionError(name)
        return r

    # ------------------------------------------------------------- control

    def elect(self) -> Replica:
        """Install a new view: the best live replica becomes primary."""
        with self._lock:
            if not self.alive:
                raise ReplicaError("no live replicas")
            best = max(self.alive.values(),
                       key=lambda r: (r.ballot, r.last_prepared))
            self.ballot = max(self.ballot, best.ballot) + 1
            self.primary = best.name
            secondaries = [n for n in self.alive if n != best.name]
            view = GroupView(self.ballot, best.name, secondaries)
            best.assume_view(view)
            for n in secondaries:
                self.alive[n].assume_view(view)
            return best

    def kill(self, name: str) -> None:
        """Hard-kill: drop the replica without flushing (data beyond the
        log is lost, which is the point). A dead process sends nothing
        more: the victim's in-flight window ends first and it accepts no
        further one, so it cannot acknowledge a write after the election.
        Its device memory is released with it, as a dead process's
        would be."""
        with self._lock:
            r = self.alive.pop(name, None)
            if r:
                with r._lock:
                    r.status = ERROR
                r.plog.close()
                r.server.close()
            if name == self.primary and self.alive:
                self.elect()

    def restart(self, name: str) -> Replica:
        """Reopen from disk; rejoin as a learner unless it wins the
        election (e.g. after a full-group crash)."""
        with self._lock:
            r = self._open(name)
            self.alive[name] = r
            if self.primary in self.alive and self.primary != name:
                r.learn_from(self.alive[self.primary])
                self.alive[self.primary].view.secondaries.append(name)
                r.assume_view(GroupView(
                    self.ballot, self.primary,
                    self.alive[self.primary].view.secondaries))
                # the decrees committed since the learn's tail reach the
                # learner now, not with the next write
                self.alive[self.primary].broadcast_commit_point()
            else:
                self.elect()
            return r

    def primary_replica(self) -> Replica:
        return self.alive[self.primary]

    def write(self, code: str, req, now=None):
        return self.primary_replica().client_write(code, req, now=now)

    def read(self, key: bytes, now=None):
        return self.primary_replica().server.on_get(key, now=now)

    def close(self):
        for r in self.alive.values():
            r.close()
