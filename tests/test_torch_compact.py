"""The port's compaction (pegasus_tpu_torch.ops.compact) against the JAX
package's, byte for byte.

The port runs backend="cuda" on device="cpu" (the device pipeline with
the plain merge) and backend="cpu" (numpy); the reference runs
backend="tpu" on JAX-CPU and backend="cpu". Every output KVBlock column
must be equal, over the tests/test_compact_ops.py matrix: dedup across
runs and newest-wins, TTL expiry, bottommost tombstones, split GC,
default_ttl, intra-run duplicates, long keys (the suffix-rank column),
the >255-run pre-combine, and cached device runs, including runs carried
over from the reference through carry.device_run_from_numpy.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu.ops import compact as ref_compact
from pegasus_tpu.ops.compact import CompactOptions as RefOptions
from pegasus_tpu_torch import carry
from pegasus_tpu_torch.engine.block import KVBlock
from pegasus_tpu_torch.ops import compact as port_compact
from pegasus_tpu_torch.ops.compact import CompactOptions
from tests.test_compact_ops import _adversarial_records, _uniform_runs, \
    make_block

FIELDS = ("key_arena", "key_off", "key_len", "val_arena", "val_off",
          "val_len", "expire_ts", "hash32", "deleted")


def to_port(block) -> KVBlock:
    return KVBlock(*[np.array(getattr(block, f)) for f in FIELDS])


def assert_same(ref_block, port_block):
    assert ref_block.n == port_block.n
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ref_block, f),
                                      getattr(port_block, f), err_msg=f)


def compare_all(runs, ref_backends=("cpu", "tpu"), **opts):
    """Compact `runs` on every backend of both packages; all outputs must
    be byte-equal. -> the reference cpu block."""
    ref = {b: ref_compact.compact_blocks(runs, RefOptions(backend=b, **opts))
           for b in ref_backends}
    port_runs = [to_port(b) for b in runs]
    port = {
        "cuda": port_compact.compact_blocks(port_runs, CompactOptions(
            backend="cuda", device="cpu", **opts)),
        "cpu": port_compact.compact_blocks(port_runs, CompactOptions(
            backend="cpu", **opts)),
    }
    want = ref[ref_backends[0]]
    for r in ref.values():
        assert_same(want.block, r.block)
    for p in port.values():
        assert_same(want.block, p.block)
        assert p.stats == want.stats
    return want.block


def test_dedup_newest_run_wins():
    newest = make_block([(b"h", b"s", b"NEW", 0, False)])
    oldest = make_block([(b"h", b"s", b"OLD", 0, False),
                         (b"h", b"t", b"KEEP", 0, False)])
    out = compare_all([newest, oldest], now=100)
    assert out.n == 2 and b"OLD" not in bytes(out.val_arena)


@pytest.mark.parametrize("bottommost", [True, False])
def test_ttl_and_tombstones(bottommost):
    newest = make_block([(b"h", b"s", b"", 0, True),
                         (b"h", b"dead", b"v", 50, False)])
    oldest = make_block([(b"h", b"alive", b"v", 1000, False),
                         (b"h", b"nottl", b"v", 0, False),
                         (b"h", b"s", b"OLD", 0, False)])
    out = compare_all([newest, oldest], now=100, bottommost=bottommost)
    assert out.n == (2 if bottommost else 3)


def test_split_stale_keys_gc():
    recs = [(f"k{i}".encode(), b"", b"v", 0, False) for i in range(64)]
    out = compare_all([make_block(recs)], now=1, pidx=2, partition_mask=3)
    assert 0 < out.n < 64


def test_default_ttl_rewrite():
    blk = make_block([(b"h", b"a", b"v", 0, False),
                      (b"h", b"b", b"v", 500, False)])
    out = compare_all([blk], now=100, default_ttl=50)
    assert sorted(out.expire_ts.tolist()) == [150, 500]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adversarial_keys_bitstable(seed):
    """Shared 40-byte prefixes (suffix-rank column), trailing zeros,
    strict-prefix pairs, empty hash keys, split GC and default_ttl."""
    rng = np.random.default_rng(seed)
    runs = [make_block(_adversarial_records(rng, 200)) for _ in range(3)]
    compare_all(runs, now=100, pidx=1, partition_mask=1,
                bottommost=(seed % 2 == 0), default_ttl=30)


def test_intra_run_duplicate_keys():
    rng = np.random.default_rng(11)
    runs = [make_block(_adversarial_records(rng, 350)) for _ in range(3)]
    compare_all(runs, now=60, bottommost=True, runs_sorted=None)


def test_sorted_run_with_duplicates_first_wins():
    recs = []
    for i in range(50):
        recs.append((b"hk%02d" % (i % 10), b"s%03d" % i, b"v%d" % i, 0, False))
        if i % 5 == 0:
            recs.append((b"hk%02d" % (i % 10), b"s%03d" % i, b"OLD", 0,
                         False))
    blk = make_block(sorted(recs, key=lambda r: (len(r[0]), r[0], r[1])))
    out = compare_all([blk], now=5, runs_sorted=True)
    assert b"OLD" not in bytes(out.val_arena)


def test_sort_block_flush_path():
    recs = [(f"hk{i % 7}".encode(), f"sk{i:03d}".encode(), b"v", i % 3 * 40,
             i % 11 == 0) for i in range(300)]
    np.random.default_rng(1).shuffle(recs)
    blk = make_block(recs)
    want = ref_compact.sort_block(blk, RefOptions(backend="cpu", now=50))
    for backend in ("cuda", "cpu"):
        got = port_compact.sort_block(to_port(blk), CompactOptions(
            backend=backend, device="cpu", now=50))
        assert_same(want, got)


def test_wide_merge_pre_combines_over_255_runs():
    runs = [make_block([(b"h%03d" % (i % 40), b"s", b"r%d" % i, 0, False)])
            for i in range(300)]
    out = compare_all(runs, ref_backends=("cpu",), now=10)
    assert out.n == 40


def _sorted_runs(seed, n_runs=3, n=300):
    rng = np.random.default_rng(seed)
    runs = []
    for r in range(n_runs):
        recs = [(b"u%05d" % rng.integers(0, 400), b"s%02d" % (i % 7),
                 b"val%d" % i, int(rng.integers(0, 3)) * 60,
                 bool(rng.random() < 0.1)) for i in range(n)]
        runs.append(ref_compact.sort_block(make_block(recs),
                                           RefOptions(backend="cpu")))
    return runs


def _carried(ref_dr):
    return carry.device_run_from_numpy(
        [np.asarray(c) for c in ref_dr.cols], np.asarray(ref_dr.klen),
        np.asarray(ref_dr.expire), np.asarray(ref_dr.deleted),
        np.asarray(ref_dr.hash32), ref_dr.n, ref_dr.padded_len, ref_dr.w,
        device="cpu")


def test_cached_runs_carried_from_reference():
    """Cached DeviceRuns carried over from the reference merge to the same
    bytes as the reference's cached merge and both cpu backends; the
    carried columns equal the port's own prime of the same blocks."""
    runs = _sorted_runs(29)
    # a narrower run: the cached merge must synthesize its missing lanes
    runs.append(ref_compact.sort_block(make_block(
        [(b"u%d" % i, b"", b"short%d" % i, 0, False) for i in range(90)]),
        RefOptions(backend="cpu")))
    opts = dict(now=100, bottommost=True, runs_sorted=True)
    ref_drs = [ref_compact.pack_run_device(b) for b in runs]
    want = ref_compact.compact_blocks(runs, RefOptions(backend="tpu", **opts),
                                      device_runs=ref_drs)
    carried = [_carried(d) for d in ref_drs]
    port_runs = [to_port(b) for b in runs]
    own = [port_compact.pack_run_device(b, device="cpu") for b in port_runs]
    for c, o, r in zip(carried, own, ref_drs):
        assert (c.n, c.padded_len, c.w) == (o.n, o.padded_len, o.w)
        for name in ("cols", "klen", "expire", "deleted", "hash32", "fence"):
            assert torch.equal(getattr(c, name), getattr(o, name)), name
        np.testing.assert_array_equal(np.asarray(r.fence), o.fence.numpy())
    for drs in (carried, own):
        got = port_compact.compact_blocks(port_runs, CompactOptions(
            backend="cuda", device="cpu", **opts), device_runs=drs)
        assert_same(want.block, got.block)
    cpu = ref_compact.compact_blocks(runs, RefOptions(backend="cpu", **opts))
    assert_same(want.block, cpu.block)


def test_cached_value_residency_matches_reference():
    rng = np.random.default_rng(31)
    runs = _uniform_runs(rng, n_runs=3, n=350)
    opts = dict(now=100, bottommost=True, runs_sorted=True)
    want = ref_compact.compact_blocks(runs, RefOptions(backend="cpu", **opts))
    port_runs = [to_port(b) for b in runs]
    drs = [port_compact.pack_run_device(b, with_values=True, device="cpu")
           for b in port_runs]
    assert all(d.val2d is not None for d in drs)
    got = port_compact.compact_blocks(port_runs, CompactOptions(
        backend="cuda", device="cpu", **opts), device_runs=drs)
    assert_same(want.block, got.block)


def test_survivor_index_out_of_range_raises():
    blk = to_port(make_block([(b"h", b"s%d" % i, b"v", 0, False)
                              for i in range(4)]))
    with pytest.raises(ValueError, match="survivor index"):
        port_compact.gather_device_survivors(
            blk, torch.tensor([0, 1, -1, 3]), 4)
    with pytest.raises(ValueError, match="survivor index"):
        port_compact.gather_device_survivors(blk, torch.tensor([0, 4]), 2)
