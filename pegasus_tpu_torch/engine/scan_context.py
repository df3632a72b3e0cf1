"""Server-pinned scan sessions (src/server/pegasus_scan_context.h:35-140).

The port's copy of pegasus_tpu/engine/scan_context.py.

A get_scanner/scan sequence holds state on the server between RPCs. Context
ids carry random high bits so a stale id from before a restart/failover
misses instead of resuming someone else's iterator (reference :100-110).
One session keeps ONE id for its whole life (the reference's fetch/put dance
re-inserts under the same id, :86-140); eviction is LRU, O(1) per op.

Evicted/cleared sessions get their iterator CLOSED, not just dropped: the
live generator pins the engine snapshot it was opened over (memtable
copies, SST handles), and the range-read iterators additionally flush
their row accounting from a ``finally`` — waiting for GC to fire those
would hold the snapshot for an unbounded time and undercount
``read.range.rows`` until collection.
"""

import random
import threading
from collections import OrderedDict


class ScanContext:
    def __init__(self, iterator, request):
        self.iterator = iterator      # the live generator over the engine
        self.request = request        # the originating GetScannerRequest
        self.id = None                # assigned by the cache at first put
        self.lock = threading.Lock()  # one scan RPC at a time per context


def _close_iterator(ctx: ScanContext) -> None:
    """Release the session's engine snapshot now (and fire the range
    iterators' accounting finallys). A parked session is never mid-pull
    (fetch removes it from the cache for the duration of a scan RPC),
    but a racing close is harmless — swallow it."""
    close = getattr(ctx.iterator, "close", None)
    if close is None:
        return
    try:
        close()
    except Exception:  # noqa: BLE001 — best-effort release
        pass


class ScanContextCache:
    def __init__(self, max_contexts: int = 1000):
        self._lock = threading.Lock()
        self._contexts = OrderedDict()  # cid -> ScanContext, LRU order
        self._max = max_contexts
        self._high_bits = random.getrandbits(16) << 32
        self._next = 0

    def put(self, ctx: ScanContext) -> int:
        """Insert (or re-insert after a fetch) keeping the session's id."""
        evicted = []
        with self._lock:
            if ctx.id is None:
                ctx.id = self._high_bits | self._next
                self._next += 1
            self._contexts[ctx.id] = ctx
            self._contexts.move_to_end(ctx.id)
            while len(self._contexts) > self._max:
                evicted.append(self._contexts.popitem(last=False)[1])
        for old in evicted:   # close outside the lock: may run finallys
            _close_iterator(old)
        return ctx.id

    def fetch(self, cid: int):
        """Remove and return (re-inserted after use via put, same id)."""
        with self._lock:
            return self._contexts.pop(cid, None)

    def remove(self, cid: int):
        with self._lock:
            ctx = self._contexts.pop(cid, None)
        if ctx is not None:
            _close_iterator(ctx)

    def __len__(self):
        with self._lock:
            return len(self._contexts)
