"""Lock-order deadlock detector: named locks and a process-wide
acquisition graph.

Port of pegasus_tpu/runtime/lockrank.py, with the same knobs, lock names
and violation records, so one violation file can collect both packages'
reports. A static pass can prove guarded state is only touched under its
lock; what it cannot see is lock ORDER: thread 1 taking A then B while
thread 2 takes B then A deadlocks although every access is guarded.
Locks get NAMES, and under ``PEGASUS_LOCKRANK=1`` every acquisition
records a held-while-acquiring edge ``held -> acquiring`` in one
process-wide graph. An edge that closes a cycle (the AB/BA inversion, or
any longer loop) is a deadlock waiting for the right interleaving: it is
reported at once, naming both acquisition sites and the cycle, without
the unlucky schedule having to happen. The test suite runs with the
detector armed, so every onebox and cluster test is also a lock-order
test.

Modules create locks through the factories instead of raw ``threading``
primitives::

    self._lock = lockrank.named_rlock("engine.lock")
    self._flush_lock = lockrank.named_lock("engine.flush")
    self._prime_cv = lockrank.named_condition("engine.prime_cv",
                                              self._lock)

With ``PEGASUS_LOCKRANK`` unset or 0 the factories return the raw
``threading`` primitives: no overhead, no change of behaviour.

Semantics:
  * names identify lock RANKS, not instances: two partitions' engine
    locks share the name "engine.lock", and same-name edges are skipped.
  * ``Condition.wait`` releases the underlying lock, and the tracking
    follows, so no held-across-wait edge can form.
  * a violation is recorded once per (held, acquiring) edge pair:
    printed to stderr, appended to ``GRAPH.violations``, and appended as
    a JSON line to ``$PEGASUS_LOCKRANK_FILE`` when set (how subprocesses
    report back to the test session). ``PEGASUS_LOCKRANK=raise`` also
    raises LockOrderError at the acquisition site.

Env knobs: PEGASUS_LOCKRANK (0 | 1 | raise), PEGASUS_LOCKRANK_FILE
(violation sink for multi-process runs).
"""

import json
import os
import sys
import threading

from .perf_counters import counters

_MODULE_FILE = os.path.abspath(__file__)


def enabled() -> bool:
    """Read per factory call (cheap), so tests/conftest can arm the
    detector before the first import of the package without a config dance."""
    return os.environ.get("PEGASUS_LOCKRANK", "0") not in ("", "0")


def _raise_mode() -> bool:
    return os.environ.get("PEGASUS_LOCKRANK", "0") == "raise"


class LockOrderError(RuntimeError):
    """A lock acquisition closed a cycle in the lock-order graph."""


class _Graph:
    """Process-wide lock-order graph. Edge a->b = "a was held while b
    was acquired", with the first witnessed (held_site, acquire_site)
    pair kept as evidence."""

    def __init__(self):
        # a RAW lock on purpose: the detector must never track itself
        self._mu = threading.Lock()
        self.edges = {}       #: guarded_by self._mu
        self.violations = []  #: guarded_by self._mu
        self._reported = set()  #: guarded_by self._mu

    def _path(self, src: str, dst: str):  #: requires self._mu
        """DFS path src -> ... -> dst over current edges, or None."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, {}):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def record(self, held: str, held_site: str, acquiring: str,
               acq_site: str):
        """Record edge held->acquiring; -> violation dict if it closes a
        cycle (first report per edge pair), else None."""
        with self._mu:
            slot = self.edges.setdefault(held, {})
            if acquiring in slot:
                # known edge: any cycle through it was detected when its
                # closing edge was FIRST inserted (every cycle has one),
                # so the steady-state cost per acquire is one dict hit
                return None
            # adding held->acquiring closes a cycle iff acquiring already
            # reaches held
            path = self._path(acquiring, held)
            slot[acquiring] = (held_site, acq_site)
            if path is None:
                return None
            key = (held, acquiring)
            if key in self._reported:
                return None
            self._reported.add(key)
            # evidence for the reverse direction: the first edge of the
            # acquiring->...->held path already in the graph
            fwd_sites = self.edges.get(path[0], {}).get(path[1], ("?", "?"))
            violation = {
                "cycle": path + [acquiring],
                "held": held, "held_site": held_site,
                "acquiring": acquiring, "acquire_site": acq_site,
                "reverse_edge": {"from": path[0], "to": path[1],
                                 "held_site": fwd_sites[0],
                                 "acquire_site": fwd_sites[1]},
                "thread": threading.current_thread().name,
                "pid": os.getpid(),
            }
            self.violations.append(violation)
        return violation

    def snapshot(self) -> dict:
        with self._mu:
            return {"edges": {a: sorted(b) for a, b in self.edges.items()},
                    "violations": list(self.violations)}

    def reset(self) -> None:
        """Test hook: forget every edge and violation."""
        with self._mu:
            self.edges.clear()
            self.violations.clear()
            self._reported.clear()


GRAPH = _Graph()

_tls = threading.local()

# the process's graph, scrapeable like any counter: a run under the
# detector shows it was armed (edges > 0) beside what it found
counters.gauge("lockrank.edges", lambda: sum(
    len(b) for b in list(GRAPH.edges.values())))
counters.gauge("lockrank.violations", lambda: len(GRAPH.violations))


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


_PATH_MEMO = {}  # raw co_filename -> short display path ('' = skip frame)


def _display_path(fn: str) -> str:
    """Memoized: '' for detector/threading frames, else the short path.
    Runs on every tracked acquire — no per-call path math."""
    cached = _PATH_MEMO.get(fn)
    if cached is None:
        if os.path.abspath(fn) == _MODULE_FILE or fn.endswith("threading.py"):
            cached = ""
        else:
            cached = os.path.relpath(fn) if fn.startswith("/") else fn
        _PATH_MEMO[fn] = cached
    return cached


def _site() -> str:
    """file:line of the acquisition, skipping detector/threading frames."""
    f = sys._getframe(1)
    while f is not None:
        p = _display_path(f.f_code.co_filename)
        if p:
            return f"{p}:{f.f_lineno}"
        f = f.f_back
    return "?:0"


def _report(violation: dict, to_sink: bool = True) -> None:
    msg = (f"[lockrank] LOCK-ORDER CYCLE "
           f"{' -> '.join(violation['cycle'])}: "
           f"{violation['held']} (held, acquired at "
           f"{violation['held_site']}) while acquiring "
           f"{violation['acquiring']} at {violation['acquire_site']}; "
           f"reverse edge {violation['reverse_edge']['from']} -> "
           f"{violation['reverse_edge']['to']} witnessed at "
           f"{violation['reverse_edge']['acquire_site']}")
    print(msg, file=sys.stderr, flush=True)
    sink = os.environ.get("PEGASUS_LOCKRANK_FILE") if to_sink else None
    if sink:
        try:
            with open(sink, "a") as f:
                f.write(json.dumps(violation) + "\n")
        except OSError:
            pass
    if _raise_mode():
        raise LockOrderError(msg)


class _NamedBase:
    """Shared acquire/release tracking over an inner threading lock."""

    def __init__(self, name: str, inner, graph: _Graph = None):
        self.name = name
        self._inner = inner
        self._graph = graph or GRAPH

    def _on_acquired(self) -> None:
        held = _held()
        site = _site()
        for hname, hsite in held:
            if hname != self.name:
                v = self._graph.record(hname, hsite, self.name, site)
                if v is not None:
                    # private graphs (tests) never write the shared sink
                    _report(v, to_sink=self._graph is GRAPH)
        held.append((self.name, site))

    def _on_released(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                self._on_acquired()
            except BaseException:
                # raise-mode violation: surface it UNLOCKED, or the
                # report itself would leave the lock dangling
                self._inner.release()
                raise
        return ok

    def release(self) -> None:
        self._inner.release()
        self._on_released()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} {self._inner!r}>"


class NamedLock(_NamedBase):
    def __init__(self, name: str, graph: _Graph = None):
        super().__init__(name, threading.Lock(), graph)


class NamedRLock(_NamedBase):
    """Named re-entrant lock. Implements the _release_save /
    _acquire_restore / _is_owned trio threading.Condition probes for, so
    a Condition built over it fully releases the recursion on wait and
    the held-stack tracking follows."""

    def __init__(self, name: str, graph: _Graph = None):
        super().__init__(name, threading.RLock(), graph)

    def _pop_all(self) -> int:
        held = _held()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                n += 1
        return n

    def _release_save(self):
        n = self._pop_all()
        return (self._inner._release_save(), n)

    def _acquire_restore(self, state):
        inner_state, n = state
        self._inner._acquire_restore(inner_state)
        held = _held()
        site = _site()
        for _ in range(n):
            held.append((self.name, site))

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def locked(self) -> bool:  # RLock has no .locked() pre-3.12
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


def named_lock(name: str, _graph: _Graph = None):
    """threading.Lock, tracked under PEGASUS_LOCKRANK=1."""
    return NamedLock(name, _graph) if enabled() else threading.Lock()


def named_rlock(name: str, _graph: _Graph = None):
    """threading.RLock, tracked under PEGASUS_LOCKRANK=1."""
    return NamedRLock(name, _graph) if enabled() else threading.RLock()


def named_condition(name: str, lock=None, _graph: _Graph = None):
    """threading.Condition over a named lock. Pass an existing
    named_lock/named_rlock to share it (the db's prime_cv rides the
    engine lock); None creates a fresh named RLock (Condition's own
    default, so wait/notify semantics are unchanged)."""
    if lock is None and enabled():
        lock = NamedRLock(name, _graph)
    return threading.Condition(lock)
