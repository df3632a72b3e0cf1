"""Named worker pools, repeating timers, and the registry of every
thread and executor the package spawns.

Port of pegasus_tpu/runtime/tasking.py's ThreadPool, Timer, spawn_thread,
tracked_executor and TRACKED (its task-code specs and pool container
are not ported: nothing in the port enqueues by task code). Heavy
compute runs in numpy and torch with the GIL released, so Python worker
threads are an adequate host executor.

spawn_thread and tracked_executor register what they create in TRACKED,
so teardown (a test module's fixture, an embedding process) can
enumerate, shut down and join every thread the package started.
"""

import heapq
import itertools
import threading
import time
import weakref

from . import lockrank


class _TrackedRegistry:
    """Process-wide ledger of every thread/executor the tracked spawn
    helpers created: a daemon thread nobody registered cannot be joined
    at teardown because nothing knows it exists. Holds weakrefs only (a
    finished thread must be collectable); `join_all` is the bounded
    backstop a test harness (or any embedding process) can call before
    interpreter finalization."""

    def __init__(self):
        self._lock = threading.Lock()  # leaf lock: nothing nests inside
        self._threads = []    #: guarded_by self._lock
        self._executors = []  #: guarded_by self._lock

    def _prune_locked(self, refs) -> list:  #: requires self._lock
        # deref each weakref ONCE: a referent collected between a guard
        # deref and a value deref would put None into the result
        pairs = [(r, r()) for r in refs]
        refs[:] = [r for r, obj in pairs if obj is not None]
        return [obj for _, obj in pairs if obj is not None]

    def register_thread(self, t) -> None:
        with self._lock:
            self._threads.append(weakref.ref(t))
            self._prune_locked(self._threads)

    def register_executor(self, ex) -> None:
        with self._lock:
            self._executors.append(weakref.ref(ex))
            self._prune_locked(self._executors)

    def live_threads(self) -> list:
        with self._lock:
            return [t for t in self._prune_locked(self._threads)
                    if t.is_alive()]

    def live_executors(self) -> list:
        with self._lock:
            return self._prune_locked(self._executors)

    def join_all(self, timeout_s: float = 5.0) -> list:
        """Shut down tracked executors (no wait) and join tracked
        threads against ONE shared deadline. Returns the threads still
        alive at the deadline (wedged daemons a caller may want to name
        before abandoning them)."""
        for ex in self.live_executors():
            try:
                ex.shutdown(wait=False)
            except Exception:  # noqa: BLE001 - teardown must keep going
                pass
        deadline = time.monotonic() + timeout_s
        leftover = []
        for t in self.live_threads():
            if t is threading.current_thread() or not t.daemon:
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                leftover.append(t)
        return leftover


TRACKED = _TrackedRegistry()


def spawn_thread(target, *args, name: str = None, daemon: bool = True,
                 start: bool = True, **kwargs):
    """The way to create a thread outside this module: the spirit of
    threading.Thread's signature, but every spawn lands in
    TRACKED so teardown can enumerate and join it. start=False returns
    an unstarted (but already registered) thread for create-then-start
    call sites."""
    t = threading.Thread(target=target, args=args, kwargs=kwargs or None,
                         name=name, daemon=daemon)
    TRACKED.register_thread(t)
    if start:
        t.start()
    return t


def tracked_executor(max_workers: int, thread_name_prefix: str = ""):
    """concurrent.futures.ThreadPoolExecutor, registered in TRACKED so
    join_all can shut it down at teardown."""
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers,
                            thread_name_prefix=thread_name_prefix)
    TRACKED.register_executor(ex)
    return ex


class ThreadPool:
    """A named fixed-size worker pool.

    Two internal queues: `_delayed` ordered by ready time, and `_ready`
    ordered by (priority desc, FIFO). Workers migrate due delayed tasks into
    the ready queue, so priority decides ordering among runnable tasks and a
    delayed task cannot starve behind a stream of immediate ones.
    """

    def __init__(self, name: str, worker_count: int = 1):
        self.name = name
        # one lock RANK for every pool ("taskpool"): pools never nest
        # their locks (workers run tasks outside the lock)
        self._lock = lockrank.named_lock("taskpool")
        # _delayed: (ready_at, seq, priority, fn, args); _ready:
        # (-priority, seq, fn, args)
        self._delayed = []  #: guarded_by self._lock
        self._ready = []    #: guarded_by self._lock
        self._counter = itertools.count()
        self._not_empty = lockrank.named_condition("taskpool", self._lock)
        self._shutdown = False  #: guarded_by self._lock
        self._workers = [
            spawn_thread(self._run, name=f"{name}.{i}", daemon=True,
                         start=False)
            for i in range(worker_count)
        ]
        for w in self._workers:
            w.start()

    def enqueue(self, fn, *args, priority: int = 1, delay_s: float = 0.0):
        with self._lock:
            if self._shutdown:
                raise RuntimeError(f"pool {self.name} is shut down")
            seq = next(self._counter)
            if delay_s <= 0:
                heapq.heappush(self._ready, (-priority, seq, fn, args))
            else:
                heapq.heappush(self._delayed, (time.monotonic() + delay_s, seq, priority, fn, args))
            self._not_empty.notify()

    def _run(self):
        while True:
            with self._lock:
                while True:
                    if self._shutdown:
                        return
                    now = time.monotonic()
                    while self._delayed and self._delayed[0][0] <= now:
                        _, seq, priority, fn, args = heapq.heappop(self._delayed)
                        heapq.heappush(self._ready, (-priority, seq, fn, args))
                    if self._ready:
                        _, _, fn, args = heapq.heappop(self._ready)
                        break
                    if self._delayed:
                        self._not_empty.wait(timeout=self._delayed[0][0] - now)
                    else:
                        self._not_empty.wait()
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - a task must never kill its worker
                import logging, traceback

                logging.getLogger("pegasus_tpu_torch.tasking").error(
                    "task raised in pool %s:\n%s", self.name, traceback.format_exc()
                )

    def stop(self):
        """Stop workers; pending (including delayed) tasks are discarded."""
        with self._lock:
            self._shutdown = True
            self._delayed.clear()
            self._ready.clear()
            self._not_empty.notify_all()
        for w in self._workers:
            w.join(timeout=5)


class Timer:
    """Repeating timer posting onto a pool; cancel() stops future firings."""

    def __init__(self, pool: ThreadPool, interval_s: float, fn, *args, first_delay_s=None):
        self._pool = pool
        self._interval = interval_s
        self._fn = fn
        self._args = args
        self._cancelled = threading.Event()
        self._schedule(self._interval if first_delay_s is None else first_delay_s)

    def _schedule(self, delay):
        if not self._cancelled.is_set():
            try:
                self._pool.enqueue(self._fire, delay_s=delay)
            except RuntimeError:
                self._cancelled.set()  # pool shut down: the timer dies with it

    def _fire(self):
        if self._cancelled.is_set():
            return
        try:
            self._fn(*self._args)
        finally:
            self._schedule(self._interval)

    def cancel(self):
        self._cancelled.set()
