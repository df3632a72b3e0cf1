"""Meta-backed partition resolver: query, cache, refresh on reconfiguration.

Port of pegasus_tpu/client/meta_resolver.py, whole.

The partition_resolver role (src/include/rrdb/rrdb.client.h:41-52): the
client asks the meta server for the app's partition table once, caches it,
and re-queries when a call fails with a routing error — which is how the
client survives primary failover transparently.
"""

import os
import threading
import time

from ..meta import messages as mm
from ..meta.meta_server import RPC_CM_QUERY_CONFIG
from ..rpc import codec
from ..rpc.transport import ConnectionPool, RpcError


class MetaResolver:
    def __init__(self, meta_addrs, app_name: str, pool: ConnectionPool = None):
        self.meta_addrs = list(meta_addrs)
        self.app_name = app_name
        self.pool = pool or ConnectionPool()
        self._lock = threading.Lock()
        self._app = None
        self._partitions = None
        self._refresh()

    @property
    def app_id(self) -> int:
        with self._lock:
            return self._app.app_id

    @property
    def partition_count(self) -> int:
        with self._lock:
            return self._app.partition_count

    def refresh(self) -> None:
        self._refresh()

    def secondaries(self, pidx: int) -> list:
        """(host, port) of the partition's secondaries — the backup-request
        targets (reads only; may serve slightly stale data)."""
        with self._lock:
            secs = list(self._partitions[pidx].secondaries)
        out = []
        for s in secs:
            host, _, port = s.rpartition(":")
            out.append((host, int(port)))
        return out

    def resolve(self, pidx: int, refresh: bool = False):
        if refresh:
            self._refresh()
        with self._lock:
            primary = self._partitions[pidx].primary
        if not primary:
            raise RpcError(4, f"partition {pidx} unassigned")
        host, _, port = primary.rpartition(":")
        return (host, int(port))

    def _refresh(self):
        """Query the partition table, trying every meta address over
        PEGASUS_META_RESOLVE_ROUNDS rounds (default 3) with a short
        backoff between rounds. One pass used to be the whole budget, and
        a FRESH connection's first call can transiently exceed its
        timeout when the meta's accept loop lags behind a loaded host
        (the parallel-suite flake: connect() completes inside listen's
        backlog before the server thread ever accept()s, so the request
        sits unread until the timeout). A wedged connection is also
        INVALIDATED before the retry — reusing the half-open socket would
        just time out again and turn one slow accept into a permanent
        'no meta server reachable'."""
        rounds = max(1, int(os.environ.get("PEGASUS_META_RESOLVE_ROUNDS",
                                           "3")))
        last = None
        for attempt in range(rounds):
            if attempt:
                time.sleep(0.05 * attempt)
            for meta in self.meta_addrs:
                host, _, port = meta.rpartition(":")
                addr = (host, int(port))
                try:
                    conn = self.pool.get(addr)
                    _, body = conn.call(RPC_CM_QUERY_CONFIG,
                                        codec.encode(mm.QueryConfigRequest(self.app_name)),
                                        timeout=5.0)
                    resp = codec.decode(mm.QueryConfigResponse, body)
                    if resp.error:
                        raise RpcError(resp.error, resp.error_text)
                    with self._lock:
                        self._app = resp.app
                        self._partitions = resp.partitions
                    return
                except (RpcError, OSError) as e:
                    last = e
                    self.pool.invalidate(addr)
        raise RpcError(7, f"no meta server reachable: {last}")
