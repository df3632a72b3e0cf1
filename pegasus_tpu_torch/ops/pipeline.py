"""Bounded double-buffered compaction pipeline executor.

Port of pegasus_tpu/ops/pipeline.py (pipeline_depth, submit,
CompactPipeline.map). Two serial loops thread through it:

  - ops/compact.py _compact_blockwise: while range i runs its device
    merge, range i+1 packs and uploads on a host worker and range i-1
    gathers and post-filters on another;
  - ops/batched_compact.py: the next chunk of partitions stacks its
    device columns on a worker under the current chunk's dispatch.

map(items, prefetch, dispatch, finish) runs `prefetch` on a shared host
worker pool, `dispatch` in the calling thread (the device work), and
`finish` on a worker again. Depth is bounded (PEGASUS_COMPACT_PIPELINE_DEPTH,
default 2 = one prefetch in flight), so at most `depth` items hold device
memory at once; depth 1 is the serial loop.

Failure contract: a stage error drains the in-flight workers (bounded
waits: a wedged worker is abandoned, never joined forever) and re-raises.
There is no lane guard in the port, so nothing reruns: the error reaches
the caller.

Accounting goes to the stage tracer (runtime/tracing.py): the calling
thread's waits on workers as `pipeline.stall` spans, and per item the
seconds its worker stages ran beside other work as `pipeline.overlap`
events; each CompactPipeline also keeps its run's stall_s and overlap_s.

The engine's deferred installs run on a second pool (install_pool,
submit_install) that holds only disk work, so a drain never waits
behind device work; the async device primes run on pipeline_pool.

Streams: a worker thread's device work runs on that thread's current
stream, by default the legacy default stream, which serialises with the
calling thread's kernels. A prefetch that should overlap them runs on a
stream of its own and hands an event to the dispatch to wait on
(ops/compact.py, ops/batched_compact.py).
"""

import os
import threading
import time

from ..runtime import lockrank
from ..runtime.fail_points import inject
from ..runtime.job_trace import JOB_TRACER
from ..runtime.tasking import tracked_executor
from ..runtime.tracing import COMPACT_TRACER as _TRACE

_DEPTH_ENV = "PEGASUS_COMPACT_PIPELINE_DEPTH"
_DEFAULT_DEPTH = 2
_POOL_WORKERS = 4
_INSTALL_WORKERS = 2
_DRAIN_TIMEOUT_S = 5.0  # the bounded wait for in-flight workers on error

_POOL = None          #: guarded_by _POOL_LOCK
_INSTALL_POOL = None  #: guarded_by _POOL_LOCK
_POOL_LOCK = lockrank.named_lock("pipeline.pool_global")


def pipeline_depth() -> int:
    """The bounded lookahead, read per call: depth N keeps at most N
    items in flight; 2 is double buffering, 1 the serial loop."""
    v = os.environ.get(_DEPTH_ENV)
    try:
        d = int(v) if v not in (None, "") else _DEFAULT_DEPTH
    except ValueError:
        d = _DEFAULT_DEPTH
    return max(1, d)


def pipeline_pool():
    """The process-wide host worker pool of the pipeline stages and the
    engine's async device primes, created at first use. Fixed size:
    deeper pipelines share its workers and queue. Its stages may touch
    the device, so never put work a drain must wait on here (that is
    what install_pool is for)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = tracked_executor(_POOL_WORKERS,
                                     thread_name_prefix="compact-pipeline")
        return _POOL


def install_pool():
    """The engine's deferred-install pool: disk-only jobs (write_sst,
    manifest, unlinks) that drains wait on. Kept apart from
    pipeline_pool so device work queued there can never starve an
    install job and hang flush, compact or close."""
    global _INSTALL_POOL
    with _POOL_LOCK:
        if _INSTALL_POOL is None:
            _INSTALL_POOL = tracked_executor(
                _INSTALL_WORKERS, thread_name_prefix="compact-install")
        return _INSTALL_POOL


def stop_pools() -> None:
    """Shut both pools down (a test module's teardown); the next submit
    creates them anew."""
    global _POOL, _INSTALL_POOL
    with _POOL_LOCK:
        pools, _POOL, _INSTALL_POOL = (_POOL, _INSTALL_POOL), None, None
    for p in pools:
        if p is not None:
            p.shutdown(wait=True)


class PipelineFuture:
    """Result slot of one worker stage; records its execution window so
    its overlap with the dispatch windows can be computed."""

    __slots__ = ("_ev", "value", "error", "started", "ended")

    def __init__(self):
        self._ev = threading.Event()
        self.value = None
        self.error = None
        self.started = 0.0
        self.ended = 0.0

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout=None) -> bool:
        return self._ev.wait(timeout)

    def result(self):
        self._ev.wait()
        if self.error is not None:
            raise self.error
        return self.value

    def duration_s(self) -> float:
        return max(0.0, self.ended - self.started)


def submit(fn, *args, pool=None) -> PipelineFuture:
    """Run fn(*args) on the pipeline pool (or an explicit pool) ->
    PipelineFuture. The worker adopts the submitting thread's active job
    for the task, so a deferred install's hop lands in the compaction
    job that queued it. The tracer's sessions are process-wide, so the
    worker's spans land in the caller's sessions without a hand-off."""
    fut = PipelineFuture()
    job_id = JOB_TRACER.current()

    def run():
        fut.started = time.perf_counter()
        try:
            with JOB_TRACER.adopt(job_id):
                inject("compact.pipeline")  # fires in every pool task
                fut.value = fn(*args)
        except BaseException as e:  # noqa: BLE001 - crosses the thread boundary
            fut.error = e
        finally:
            fut.ended = time.perf_counter()
            fut._ev.set()

    (pool or pipeline_pool()).submit(run)
    return fut


def submit_install(fn, *args) -> PipelineFuture:
    """submit() onto the disk-only install pool (see install_pool)."""
    return submit(fn, *args, pool=install_pool())


def _fut_interval(f):
    """(start, end) of a finished worker future; None if it never ran or
    is still running (a timed-out, abandoned prefetch)."""
    if f is None or f.started == 0.0 or f.ended == 0.0:
        return None
    return (f.started, f.ended)


def _overlap_len(interval, others) -> float:
    """Seconds of `interval` during which each of the other intervals was
    also executing, summed per other."""
    t0, t1 = interval
    return sum(max(0.0, min(t1, e) - max(t0, s)) for s, e in others)


class CompactPipeline:
    """One bounded pipelined run over a list of work items. Create one
    instance per run: all state is local to it."""

    def __init__(self, depth: int = None, prefetch_timeout_s: float = None):
        self.depth = pipeline_depth() if depth is None else max(1, depth)
        # None = wait for a prefetch as long as it takes. With a bound, a
        # timed-out worker is abandoned and dispatch receives a
        # TimeoutError in place of the prefetched value, to redo the work
        # inline or raise
        self.prefetch_timeout_s = prefetch_timeout_s
        self.stall_s = 0.0
        self.overlap_s = 0.0
        self.drains = 0

    def map(self, items, prefetch, dispatch, finish=None) -> list:
        """For each item i: prefetch(item) on a worker (lookahead
        depth - 1), dispatch(i, prefetched) in the calling thread,
        finish(i, dispatched) on a worker (at most `depth` unfinished).
        -> the finish (or dispatch) results in item order. A stage error
        drains the in-flight workers (bounded) and re-raises."""
        n = len(items)
        if self.depth <= 1 or n <= 1:
            out = []
            for i, item in enumerate(items):
                d = dispatch(i, prefetch(item))
                out.append(finish(i, d) if finish is not None else d)
            return out
        lookahead = self.depth - 1
        pref = [None] * n
        fin = [None] * n
        results = [None] * n
        windows = []
        t_start = time.perf_counter()
        try:
            for i in range(n):
                for j in range(i, min(n, i + lookahead + 1)):
                    if pref[j] is None:
                        pref[j] = submit(prefetch, items[j])
                p = self._take(pref[i])
                t0 = time.perf_counter()
                d = dispatch(i, p)
                windows.append((t0, time.perf_counter()))
                if finish is None:
                    results[i] = d
                    continue
                k = i - self.depth
                if k >= 0:
                    self._wait(fin[k])
                fin[i] = submit(finish, i, d)
            if finish is not None:
                for i in range(n):
                    self._wait(fin[i])
                    results[i] = fin[i].result()
        except BaseException:
            self._drain(pref + fin)
            self.drains += 1
            raise
        self._account(windows, pref, fin, time.perf_counter() - t_start)
        return results

    def _wait(self, fut, timeout: float = None) -> None:
        if fut is None or fut.done():
            return
        t0 = time.perf_counter()
        with _TRACE.span("pipeline.stall"):
            fut.wait(timeout)
        self.stall_s += time.perf_counter() - t0

    def _take(self, fut):
        """A prefetch's result, waited for at most prefetch_timeout_s: a
        timed-out worker is abandoned and a TimeoutError takes the value's
        place (returned, not raised: the dispatch decides)."""
        self._wait(fut, self.prefetch_timeout_s)
        if not fut.done():
            return TimeoutError(
                f"pipeline prefetch exceeded {self.prefetch_timeout_s:.1f}s;"
                " worker abandoned")
        return fut.result()

    def _drain(self, futures) -> None:
        """Quiesce in-flight workers before re-raising: a bounded wait per
        future; a wedged worker is abandoned."""
        deadline = time.monotonic() + _DRAIN_TIMEOUT_S
        for f in futures:
            if f is None or f.done():
                continue
            f.wait(max(0.0, deadline - time.monotonic()))

    def _account(self, windows, pref, fin, wall_s) -> None:
        futures = pref + fin
        stage_s = wall_s - self.stall_s  # calling-thread time in stages
        stage_s += sum(f.duration_s() for f in futures if f is not None)
        self.overlap_s = max(0.0, stage_s - wall_s)
        # per item: the seconds its worker stages (prefetch + finish) ran
        # beside dispatch windows or other items' workers, the host time
        # the pipeline hid for it
        all_iv = {id(f): _fut_interval(f) for f in futures if f is not None}
        for i in range(len(pref)):
            own = [f for f in (pref[i], fin[i])
                   if f is not None and _fut_interval(f) is not None]
            if not own:
                continue
            own_ids = {id(f) for f in own}
            others = list(windows) + [iv for fid, iv in all_iv.items()
                                      if iv is not None
                                      and fid not in own_ids]
            ov = sum(_overlap_len(_fut_interval(f), others) for f in own)
            if ov > 0.0:
                _TRACE.event("pipeline.overlap", ov)
