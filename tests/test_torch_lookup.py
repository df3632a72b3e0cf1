"""The port's device reads (pegasus_tpu_torch.ops.device_lookup) against
the JAX package's lookup_batch / range_batch and the host SSTable walk.

Row indices must be equal for random and dense single-hashkey runs,
including queries longer than the run's prefix window (klen tie-break),
strict prefixes, misses on both ends, inverted ranges and open stops.
"""

import functools

import numpy as np
import pytest
import torch

from pegasus_tpu.base.key_schema import generate_key, generate_next_bytes
from pegasus_tpu.ops import compact as ref_compact
from pegasus_tpu.ops import device_lookup as ref_lookup
from pegasus_tpu_torch.engine.sstable import SSTable, write_sst
from pegasus_tpu_torch.ops import compact as port_compact
from pegasus_tpu_torch.ops import device_lookup as port_lookup
from tests.test_compact_ops import make_block
from tests.test_torch_compact import _carried, to_port


def _run(kind: str):
    rng = np.random.default_rng(5)
    if kind == "random":
        recs = [(b"hk%04d" % rng.integers(0, 3000), b"s%d" % rng.integers(0, 9),
                 b"v", 0, False) for _ in range(2500)]
    else:  # dense: one hashkey, sort keys crowd the fence blocks
        recs = [(b"onehash", b"%06d" % i, b"v", 0, False)
                for i in range(0, 6000, 3)]
    blk = ref_compact.sort_block(make_block(recs),
                                 ref_compact.CompactOptions(backend="cpu"))
    return blk


def _queries(blk, rng):
    keys = [blk.key(int(i)) for i in rng.integers(0, blk.n, size=150)]
    keys += [k + b"\x00" for k in keys[:20]]           # just above a key
    keys += [k[:-1] for k in keys[:20]]                # strict prefixes
    keys += [k + b"X" * 40 for k in keys[:20]]         # beyond the window
    keys += [b"", b"\x00", b"\xff" * 50, blk.key(0), blk.key(blk.n - 1)]
    return keys


@pytest.fixture(params=["random", "dense"])
def runs(request, tmp_path):
    blk = _run(request.param)
    ref_dr = ref_compact.pack_run_device(blk)
    port_blk = to_port(blk)
    path = str(tmp_path / "000001.sst")
    write_sst(path, port_blk)
    sst = SSTable(path)
    return blk, ref_dr, [_carried(ref_dr),
                         port_compact.pack_run_device(port_blk,
                                                      device="cpu")], sst


def test_lookup_rows_match_reference_and_host(runs):
    blk, ref_dr, port_drs, sst = runs
    keys = _queries(blk, np.random.default_rng(1))
    want = ref_lookup.lookup_batch(ref_dr, keys)
    host = np.array([sst.find(k) for k in keys], np.int32)
    np.testing.assert_array_equal(want, host)
    for dr in port_drs:
        np.testing.assert_array_equal(port_lookup.lookup_batch(dr, keys),
                                      want)


def test_range_rows_match_reference_and_host(runs):
    blk, ref_dr, port_drs, sst = runs
    rng = np.random.default_rng(2)
    q = _queries(blk, rng)
    ranges = [(q[i], q[i + 1]) for i in range(0, len(q) - 1, 2)]
    ranges += [(blk.key(10), None), (b"\x00", None),
               (blk.key(50), blk.key(20)),                     # inverted
               (generate_key(b"hk0001"), generate_next_bytes(b"hk0001"))]
    want = ref_lookup.range_batch(ref_dr, ranges)
    host = np.array([(sst.lower_bound(s),
                      max(sst.lower_bound(s),
                          sst.lower_bound(t) if t is not None else sst.n))
                     for s, t in ranges], np.int32)
    np.testing.assert_array_equal(want, host)
    for dr in port_drs:
        np.testing.assert_array_equal(port_lookup.range_batch(dr, ranges),
                                      want)


def test_all_open_stops_and_empty_batches(runs):
    blk, ref_dr, port_drs, _ = runs
    ranges = [(blk.key(i), None) for i in (0, 7, blk.n - 1)]
    want = ref_lookup.range_batch(ref_dr, ranges)
    for dr in port_drs:
        np.testing.assert_array_equal(port_lookup.range_batch(dr, ranges),
                                      want)
        assert port_lookup.lookup_batch(dr, []).shape == (0,)
        assert port_lookup.range_batch(dr, []).shape == (0, 2)


def test_fence_index_matches_reference(runs):
    _, ref_dr, port_drs, _ = runs
    for dr in port_drs:
        assert (dr.fence_len, dr.fence_step) == (ref_dr.fence_len,
                                                 ref_dr.fence_step)
        np.testing.assert_array_equal(dr.fence.numpy(),
                                      np.asarray(ref_dr.fence))


# ------------------------------------------- the kernel's plain version

@functools.lru_cache(maxsize=1)
def _edge_cases():
    import chip_smoke

    return chip_smoke.lookup_probe_cases("cpu")


@functools.lru_cache(maxsize=1)
def _edge_runs():
    import chip_smoke

    return {name: keys for name, _, keys in chip_smoke.lookup_edge_runs("cpu")}


def _ref_run(keys):
    from pegasus_tpu.engine.block import KVBlock as RefBlock

    return ref_compact.pack_run_device(RefBlock.from_records(
        [(k, b"v", 0, False) for k in keys],
        hashes=np.zeros(len(keys), np.uint64)))


@pytest.mark.parametrize("run", ["n1", "n5", "one_lane", "high_bit",
                                 "dense", "random", "serve_lane0", "wide"])
def test_plain_version_matches_reference_and_host_on_edge_runs(run):
    """fence_lookup_plain (the kernel's yardstick) on the kernel's edge
    cases: runs of 1 and 5 rows, one-lane runs, high-bit lanes, a crowded
    hash key, a serve partition's keys in small, a window above 33 * 33
    rows; 1, 127, 129, 300 and 4097 queries; points and ranges. Rows
    equal the host walk, and the JAX package's lookup_batch /
    range_batch at 300 queries."""
    import bisect

    import torch

    dr_keys = _edge_runs()[run]
    ref_dr = _ref_run(dr_keys)
    for name, dr, points, ranges, keys_q, ranges_q in _edge_cases():
        if name.split("/")[0] != run:
            continue
        got = port_lookup.fence_lookup_plain(dr, points).numpy()
        assert got.dtype == np.int32
        host = np.array([i if i < len(dr_keys) and dr_keys[i] == k else -1
                         for k in keys_q
                         for i in [bisect.bisect_left(dr_keys, k)]],
                        np.int32)
        np.testing.assert_array_equal(got, host, err_msg=name)
        # the JAX package at one query count per run (each count is a
        # program of its own there)
        with_ref = name.endswith("/q300")
        if with_ref:
            np.testing.assert_array_equal(
                got, ref_lookup.lookup_batch(ref_dr, keys_q), err_msg=name)
        got_r = port_lookup.fence_lookup_plain(dr, ranges).numpy()
        lb = [(bisect.bisect_left(dr_keys, s), bisect.bisect_left(dr_keys, t))
              for s, t in ranges_q]
        np.testing.assert_array_equal(
            got_r, np.array([(a, max(a, b)) for a, b in lb], np.int32),
            err_msg=name)
        if with_ref:
            np.testing.assert_array_equal(
                got_r, ref_lookup.range_batch(ref_dr, ranges_q),
                err_msg=name)
        # one upload: every set of a probe in one int64 buffer
        assert points.dtype == torch.int64 and points.shape == (
            1, dr.w + 1, len(keys_q))


def test_cpu_runs_take_the_plain_version():
    from pegasus_tpu_torch.ops import fence_lookup

    before = fence_lookup.LAUNCHES["fence_lookup"]
    name, dr, points, ranges, _, _ = _edge_cases()[0]
    port_lookup.fence_lookup(dr, points)
    port_lookup.fence_lookup(dr, ranges)
    assert fence_lookup.LAUNCHES["fence_lookup"] == before


# ------------------------------- Pegasus keys and the kernel's search

def _pegasus_keys(n: int = 4000) -> list:
    """Stored keys of a serve partition in small: YCSB's hashed names
    ("user" + fnvhash64(rank)) under sort key field0."""
    import chip_smoke

    rows, lens = chip_smoke.ycsb_hash_keys(np.arange(n, dtype=np.int64))
    return sorted({generate_key(rows[i, :lens[i]].tobytes(),
                                chip_smoke.SERVE_FIELD) for i in range(n)})


def _pegasus_queries(dr, keys, rng) -> list:
    """Hits, misses beside them, strict prefixes, keys past the 4w-byte
    window, the run's ends, and the keys at and beside every 32nd fence
    sample (the ends of the reference's fence windows)."""
    import chip_smoke

    q = chip_smoke.lookup_queries(keys, rng, 300)
    for pos in range(0, dr.fence_len, 32):
        i = min(pos * dr.fence_step, dr.n - 1)
        for j in (i - 1, i, i + 1):
            if 0 <= j < dr.n:
                q += [keys[j], keys[j] + b"\x00", keys[j][:-1],
                      keys[j] + b"Z" * (4 * dr.w)]
    return q[:512]


@pytest.fixture(scope="module")
def pegasus_run():
    import chip_smoke

    keys = _pegasus_keys()
    dr, keys = chip_smoke._key_run(keys, "cpu")
    return dr, keys, _ref_run(keys)


def test_pegasus_run_fence_narrows_nothing(pegasus_run):
    """The run the kernel was redesigned for: the first lane (the 2-byte
    hashkey length and two hashkey bytes) takes a handful of values, so
    the fence window of a query is most of the run."""
    dr, keys, _ = pegasus_run
    assert len(set(dr.cols[0][:dr.n].tolist())) <= 5
    assert len(set(dr.fence.tolist())) <= 5


def test_pegasus_run_plain_matches_reference(pegasus_run):
    """Points and ranges through the port's fence_lookup_plain against
    the JAX package's lookup_batch / range_batch on a Pegasus-shaped run,
    at window ends, strict prefixes and keys longer than 4w bytes."""
    import bisect

    dr, keys, ref_dr = pegasus_run
    q = _pegasus_queries(dr, keys, np.random.default_rng(11))
    got = port_lookup.fence_lookup_plain(
        dr, port_lookup.pack_queries([q], dr.w, "cpu")).numpy()
    np.testing.assert_array_equal(got, ref_lookup.lookup_batch(ref_dr, q))
    assert (got >= 0).sum() > 100 and (got < 0).sum() > 100
    ranges = [(q[i], q[(i + 7) % len(q)]) for i in range(len(q))]
    got_r = port_lookup.fence_lookup_plain(
        dr, port_lookup.pack_queries([[a for a, _ in ranges],
                                      [b for _, b in ranges]], dr.w,
                                     "cpu")).numpy()
    np.testing.assert_array_equal(got_r, ref_lookup.range_batch(ref_dr,
                                                                ranges))
    np.testing.assert_array_equal(
        got_r[:, 0], [bisect.bisect_left(keys, a) for a, _ in ranges])


@pytest.mark.parametrize("run", ["n1", "n5", "one_lane", "high_bit",
                                 "dense", "random", "serve_lane0", "wide"])
def test_search_model_matches_plain_on_edge_runs(run):
    """The kernel's search (fence_lookup.search_model) at each of the
    kernel's lanes per query equals fence_lookup_plain on every edge
    case, points and ranges."""
    from pegasus_tpu_torch.ops.fence_lookup import GROUPS, search_model

    for name, dr, points, ranges, _, _ in _edge_cases():
        if name.split("/")[0] != run:
            continue
        for packed in (points, ranges):
            want = port_lookup.fence_lookup_plain(dr, packed)
            for group in GROUPS:
                got, rounds = search_model(dr, packed, group)
                assert got.dtype == want.dtype
                assert torch.equal(got, want), (name, group)
                assert int(rounds.min()) >= 1


def test_search_model_matches_plain_on_pegasus_run(pegasus_run):
    from pegasus_tpu_torch.ops.fence_lookup import GROUPS, search_model

    dr, keys, _ = pegasus_run
    q = _pegasus_queries(dr, keys, np.random.default_rng(12))
    for packed in (port_lookup.pack_queries([q], dr.w, "cpu"),
                   port_lookup.pack_queries([q, q[1:] + q[:1]], dr.w,
                                            "cpu")):
        want = port_lookup.fence_lookup_plain(dr, packed)
        for group in GROUPS:
            assert torch.equal(search_model(dr, packed, group)[0], want)


def test_search_model_rounds_on_pegasus_runs(pegasus_run):
    """At most 5 dependent rounds per query on the Pegasus-shaped run,
    where a binary search takes ~log2(n); and 4 at a whole
    serve partition's 312 500 rows (the binary search: 19, and one load
    more for a point's equality)."""
    import chip_smoke
    from pegasus_tpu_torch.ops.fence_lookup import search_model

    dr, keys, _ = pegasus_run
    packed = port_lookup.pack_queries(
        [_pegasus_queries(dr, keys, np.random.default_rng(13))], dr.w, "cpu")
    _, rounds = search_model(dr, packed, 32)
    assert int(rounds.max()) <= 5
    assert int(chip_smoke.fence_rounds(dr, packed).max()) >= 11
    big, big_keys = chip_smoke.serve_partition_run("cpu")
    rng = np.random.default_rng(14)
    q = [big_keys[int(i)] for i in rng.integers(0, big.n, 64)]
    packed = port_lookup.pack_queries([q], big.w, "cpu")
    got, rounds = search_model(big, packed)
    assert torch.equal(got, port_lookup.fence_lookup_plain(big, packed))
    assert int(rounds.max()) == 4
    assert int(chip_smoke.fence_rounds(big, packed).max()) >= 17


def test_launch_checks_raise_before_the_card():
    """The wrapper's guards raise on what the kernel does not take, before
    any launch: a buffer of the wrong width, a group the kernel has no
    instantiation for, a depth short of the run, a wrong dtype."""
    from pegasus_tpu_torch.ops import fence_lookup as fl

    name, dr, points, ranges, _, _ = _edge_cases()[0]
    steps = port_lookup.lookup_steps(dr)
    with pytest.raises(ValueError):
        fl.launch(dr, points[:, :-1], steps)
    with pytest.raises(ValueError):
        fl.launch_group(dr, points, steps, 12)
    big = next(d for n, d, *_ in _edge_cases() if n.startswith("wide/"))
    with pytest.raises(ValueError):
        fl.launch(big, port_lookup.pack_queries([[b"x"]], big.w, "cpu"), 3)
    with pytest.raises(TypeError):
        fl.launch(dr, points.to(torch.int32), steps)
    assert fl.group_for(64) in fl.GROUPS and fl.group_for(4097) in fl.GROUPS
