"""The port's pipeline executor (pegasus_tpu_torch.ops.pipeline) and its
blockwise compaction (ops/compact.py _compact_blockwise) against the JAX
package.

Executor: item order at every depth, dispatch and prefetch errors raised
(after a drain), the prefetch timeout's marker, the stall and overlap
accounting in the stage tracer. Blockwise: on the port's cuda backend
(plain merge on the CPU) at depth 1 and 2, byte-equal to the whole merge
and to the reference's blockwise run on the shapes of
tests/test_compact_ops.py and tests/test_pipeline.py: budgets 500 / 1000
/ 2500, boundary-straddling duplicates with TTL and tombstone edges, the
long-key (suffix-rank) path, degenerate and single repeated keys, and
user rules with default_ttl.
"""

import threading
import time
from dataclasses import replace

import numpy as np
import pytest

from pegasus_tpu.engine import compaction_rules as ref_rules
from pegasus_tpu.ops import compact as ref_compact
from pegasus_tpu.ops.compact import CompactOptions as RefOptions
from pegasus_tpu_torch.engine import compaction_rules as port_rules
from pegasus_tpu_torch.ops import compact as port_compact
from pegasus_tpu_torch.ops.compact import CompactOptions
from pegasus_tpu_torch.ops.pipeline import CompactPipeline, pipeline_depth
from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER
from tests.test_compact_ops import make_block
from tests.test_pipeline import _boundary_straddle_runs
from tests.test_torch_compact import assert_same, to_port

DEPTH = "PEGASUS_COMPACT_PIPELINE_DEPTH"


# ------------------------------------------------------------- executor


def test_depth_env_knob(monkeypatch):
    monkeypatch.delenv(DEPTH, raising=False)
    assert pipeline_depth() == 2
    for value, want in (("4", 4), ("0", 1), ("-3", 1), ("junk", 2)):
        monkeypatch.setenv(DEPTH, value)
        assert pipeline_depth() == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_map_preserves_item_order(depth):
    log = []

    def dispatch(i, p):
        log.append(i)
        return p + i

    out = CompactPipeline(depth=depth).map(
        list(range(7)), lambda x: x * 10, dispatch, lambda i, d: d + 1)
    assert out == [x * 10 + x + 1 for x in range(7)]
    assert log == list(range(7))


def test_map_without_finish_returns_dispatch_results():
    assert CompactPipeline(depth=2).map(
        [3, 4], lambda x: x, lambda i, p: p * p) == [9, 16]


def test_dispatch_error_drains_and_raises():
    def dispatch(i, p):
        if i == 1:
            raise RuntimeError("device died")
        return p

    pipe = CompactPipeline(depth=2)
    with pytest.raises(RuntimeError, match="device died"):
        pipe.map(list(range(4)), lambda x: x, dispatch, lambda i, d: d)
    assert pipe.drains == 1


def test_prefetch_and_finish_errors_raise_on_their_item():
    def prefetch(x):
        if x == 2:
            raise ValueError("bad pack")
        return x

    with pytest.raises(ValueError, match="bad pack"):
        CompactPipeline(depth=2).map(list(range(4)), prefetch,
                                     lambda i, p: p)

    def finish(i, d):
        if i == 3:
            raise KeyError("bad gather")
        return d

    with pytest.raises(KeyError, match="bad gather"):
        CompactPipeline(depth=2).map(list(range(5)), lambda x: x,
                                     lambda i, p: p, finish)


def test_prefetch_timeout_dispatches_marker_not_hang():
    release = threading.Event()
    seen = []

    def prefetch(x):
        if x == 1:
            release.wait(10)
        return x

    def dispatch(i, p):
        seen.append(type(p).__name__)
        return p

    try:
        t0 = time.perf_counter()
        out = CompactPipeline(depth=2, prefetch_timeout_s=0.2).map(
            [0, 1, 2], prefetch, dispatch)
        assert time.perf_counter() - t0 < 5.0
        assert seen == ["int", "TimeoutError", "int"]
        assert isinstance(out[1], TimeoutError)
    finally:
        release.set()


def test_stall_and_overlap_reach_the_tracer():
    """Sleeping stages on two threads: the run's wall time undercuts the
    serial sum; the waits are `pipeline.stall` spans and the hidden
    worker time `pipeline.overlap` events in the active session."""
    n = 4

    def prefetch(x):
        time.sleep(0.1)
        return x

    def dispatch(i, p):
        time.sleep(0.1)
        return p

    pipe = CompactPipeline(depth=2)
    with COMPACT_TRACER.session() as sess:
        t0 = time.perf_counter()
        pipe.map(list(range(n)), prefetch, dispatch)
        wall = time.perf_counter() - t0
    assert wall < n * 0.2 * 0.9, wall
    # the first prefetch is always a stall: nothing runs beside it
    assert pipe.overlap_s > 0.0 and pipe.stall_s >= 0.08
    stall = sess.stages["pipeline.stall"]
    assert stall["calls"] >= 1 and 0.08 <= stall["s"] <= pipe.stall_s
    assert sess.stages["pipeline.overlap"]["s"] > 0.0


# ------------------------------------------------------------ blockwise


def _whole_merge_runs():
    """test_blockwise_merge_matches_whole_merge's inputs."""
    rng = np.random.default_rng(41)
    recs = []
    for i in range(4000):
        hk = b"u%06d" % rng.integers(0, 1500)
        deleted = bool(rng.random() < 0.08)
        expire = int(rng.integers(0, 3)) * 50
        recs.append((hk, b"s%d" % (i % 5), b"" if deleted else b"w%d" % i,
                     expire, deleted))
    return [ref_compact.sort_block(make_block(part),
                                   RefOptions(backend="cpu"))
            for part in (recs[:1500], recs[1500:2600], recs[2600:])]


def _port_blockwise(runs, budget, depth, monkeypatch, **kw):
    monkeypatch.setenv(DEPTH, str(depth))
    return port_compact.compact_blocks(
        [to_port(b) for b in runs],
        CompactOptions(backend="cuda", device="cpu", runs_sorted=True,
                       max_device_records=budget, **kw))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("budget", [500, 1000, 2500])
def test_blockwise_matches_whole_merge_and_reference(budget, depth,
                                                     monkeypatch):
    runs = _whole_merge_runs()
    whole = ref_compact.compact_blocks(runs, RefOptions(
        backend="cpu", now=60, runs_sorted=True))
    monkeypatch.setenv(DEPTH, str(depth))
    ref_split = ref_compact.compact_blocks(runs, RefOptions(
        backend="tpu", now=60, runs_sorted=True, max_device_records=budget))
    assert_same(whole.block, ref_split.block)
    got = _port_blockwise(runs, budget, depth, monkeypatch, now=60)
    assert_same(whole.block, got.block)
    assert got.stats == ref_split.stats


def test_blockwise_runs_the_ranges_through_the_device_stage(monkeypatch):
    runs = _whole_merge_runs()
    for depth in (1, 2):
        with COMPACT_TRACER.session() as sess:
            _port_blockwise(runs, 1500, depth, monkeypatch, now=60)
        assert sess.stages["device"]["calls"] == 3, depth
        assert "pack" in sess.stages and "gather" in sess.stages


@pytest.mark.parametrize("seed", [0, 1])
def test_blockwise_depths_equal_on_boundary_straddling_keys(seed,
                                                            monkeypatch):
    runs = _boundary_straddle_runs(np.random.default_rng(seed))
    whole = ref_compact.compact_blocks(runs, RefOptions(
        backend="cpu", now=100, bottommost=True, runs_sorted=True))
    for budget in (300, 700):
        outs = [_port_blockwise(runs, budget, d, monkeypatch, now=100,
                                bottommost=True) for d in (1, 2)]
        for got in outs:
            assert_same(whole.block, got.block)
        assert outs[0].stats == outs[1].stats


def test_blockwise_long_keys_rank_path(monkeypatch):
    rng = np.random.default_rng(43)
    recs = [(b"verylonghashkeyprefix-%038d" % rng.integers(0, 400),
             b"s%d" % (i % 3), b"v%d" % i, 0, False) for i in range(1200)]
    runs = [ref_compact.sort_block(make_block(part),
                                   RefOptions(backend="cpu"))
            for part in (recs[:600], recs[600:])]
    whole = ref_compact.compact_blocks(runs, RefOptions(
        backend="tpu", now=60, runs_sorted=True))
    for depth in (1, 2):
        got = _port_blockwise(runs, 400, depth, monkeypatch, now=60)
        assert_same(whole.block, got.block)


def test_degenerate_and_single_repeated_keys_terminate(monkeypatch):
    """Ranges that cannot shrink below the budget go direct and stop."""
    hot = [(b"hotA", b"s", b"v%d" % i, 0, False) for i in range(120)] \
        + [(b"hotB", b"s", b"w%d" % i, 0, False) for i in range(120)]
    cold = [(b"z%03d" % i, b"s", b"c%d" % i, 0, False) for i in range(40)]
    one = ref_compact.sort_block(make_block(hot + cold),
                                 RefOptions(backend="cpu"))
    want = ref_compact.compact_blocks([one, one], RefOptions(
        backend="cpu", now=50, runs_sorted=True))
    same = ref_compact.sort_block(make_block(
        [(b"k", b"s", b"v%d" % i, 0, False) for i in range(50)]),
        RefOptions(backend="cpu"))
    for depth in (1, 2):
        got = _port_blockwise([one, one], 50, depth, monkeypatch, now=50)
        assert_same(want.block, got.block)
        res = _port_blockwise([same, same], 10, depth, monkeypatch, now=50)
        assert res.block.n == 1


def test_blockwise_user_rules_and_default_ttl(monkeypatch):
    text = ('{"ops": [{"type": "COT_DELETE", "params": "{}", "rules": '
            '[{"type": "FRT_SORTKEY_PATTERN", "params": "{\\"pattern\\": '
            '\\"s1\\", \\"match_type\\": \\"SMT_MATCH_PREFIX\\"}"}]}]}')
    runs = _whole_merge_runs()
    want = ref_compact.compact_blocks(runs, RefOptions(
        backend="cpu", now=60, runs_sorted=True, default_ttl=300,
        user_ops=tuple(ref_rules.parse_user_specified_compaction(text))))
    ops = tuple(port_rules.parse_user_specified_compaction(text))
    for depth in (1, 2):
        got = _port_blockwise(runs, 1000, depth, monkeypatch, now=60,
                              default_ttl=300, user_ops=ops)
        assert_same(want.block, got.block)


def test_blockwise_pins_now_once(monkeypatch):
    """Without an explicit now, every range filters against one clock:
    the output equals a whole merge at the clock the first range read."""
    runs = _whole_merge_runs()
    clock = iter(range(10, 10_000, 7))
    monkeypatch.setattr(port_compact, "epoch_now", lambda: next(clock))
    got = _port_blockwise(runs, 500, 2, monkeypatch)
    want = ref_compact.compact_blocks(runs, RefOptions(
        backend="cpu", now=10, runs_sorted=True))
    assert_same(want.block, got.block)


def test_unsorted_or_cpu_merges_never_go_blockwise(monkeypatch):
    runs = _whole_merge_runs()
    calls = []
    real = port_compact._compact_blockwise
    monkeypatch.setattr(port_compact, "_compact_blockwise",
                        lambda *a: calls.append(1) or real(*a))
    port_runs = [to_port(b) for b in runs]
    for opts in (CompactOptions(backend="cpu", now=60, runs_sorted=True,
                                max_device_records=500),
                 CompactOptions(backend="cuda", device="cpu", now=60,
                                max_device_records=500)):
        port_compact.compact_blocks(port_runs, opts)
    assert not calls
    port_compact.compact_blocks(port_runs, replace(opts, runs_sorted=True))
    assert calls
