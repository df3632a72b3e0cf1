"""The port's device reads (pegasus_tpu_torch.ops.device_lookup) against
the JAX package's lookup_batch / range_batch and the host SSTable walk.

Row indices must be equal for random and dense single-hashkey runs,
including queries longer than the run's prefix window (klen tie-break),
strict prefixes, misses on both ends, inverted ranges and open stops.
"""

import numpy as np
import pytest

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
