"""The port's batched multi-partition compaction
(pegasus_tpu_torch.ops.batched_compact) against the JAX package's, and
the batched plain merge under it.

The cases of tests/test_batched_compact.py without the mesh and the
replica stub: every partition's output byte-equal to the port's per-job
compact_blocks(device_runs=...) and to the reference's
compact_partition_batch(mesh=None) on the same seeded inputs; per-row
split GC masks; user rules and default_ttl through opts and per job
through post_opts; groups chunked by max_device_records; a single job
over the budget through compact_blocks (blockwise). The batched plain
merge and plain splits equal the 2-D ones row by row, on chip_smoke's
batched kernel cases (among them rows that differ only in their key
columns or only in their payload).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import chip_smoke
from pegasus_tpu.engine import compaction_rules as ref_rules
from pegasus_tpu.ops.batched_compact import \
    compact_partition_batch as ref_batch
from pegasus_tpu.ops.compact import CompactOptions as RefOptions
from pegasus_tpu_torch.engine import compaction_rules as port_rules
from pegasus_tpu_torch.ops import batched_compact
from pegasus_tpu_torch.ops.batched_compact import compact_partition_batch
from pegasus_tpu_torch.ops.compact import (CompactOptions, compact_blocks,
                                           pack_run_device)
from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
from pegasus_tpu_torch.ops.merge_path import (merge_path_splits,
                                              merge_path_splits_plain,
                                              merge_two_sorted)
from tests.test_batched_compact import make_partition
from tests.test_torch_compact import assert_same, to_port

RULES = ('{"ops": [{"type": "COT_DELETE", "params": "{}", "rules": '
         '[{"type": "FRT_SORTKEY_PATTERN", "params": "{\\"pattern\\": '
         '\\"s1\\", \\"match_type\\": \\"SMT_MATCH_PREFIX\\"}"}]}]}')


def make_jobs(specs, k_runs=2, hk_space=120):
    """specs: (seed, n, pidx) per job. -> (reference jobs, port jobs) on
    the same blocks; the port's runs primed on the CPU."""
    ref_jobs, port_jobs = [], []
    for seed, n, pidx in specs:
        runs, drs = make_partition(seed, n, hk_space=hk_space,
                                   k_runs=k_runs)
        ref_jobs.append((runs, drs, pidx))
        port_runs = [to_port(b) for b in runs]
        port_jobs.append((port_runs, [pack_run_device(b, device="cpu")
                                      for b in port_runs], pidx))
    return ref_jobs, port_jobs


def check(ref_jobs, port_jobs, ref_opts, opts, post=None, ref_post=None):
    """Both packages' batched outputs and the port's per-job merges must
    be byte-equal. -> the port's outputs."""
    want = ref_batch(ref_jobs, ref_opts, post_opts=ref_post)
    got = compact_partition_batch(port_jobs, opts, post_opts=post)
    assert len(got) == len(port_jobs)
    for j, ((runs, drs, pidx), w, g) in enumerate(zip(port_jobs, want, got)):
        assert_same(w, g)
        per = compact_blocks(runs, replace(post[j] if post else opts,
                                           pidx=pidx, now=opts.now,
                                           backend="cuda", device="cpu",
                                           runs_sorted=True,
                                           partition_mask=opts.partition_mask),
                             device_runs=drs)
        assert_same(per.block, g)
    return got


def _opts(**kw):
    base = dict(now=60, bottommost=True, runs_sorted=True)
    base.update(kw)
    return (RefOptions(backend="tpu", **base),
            CompactOptions(backend="cuda", device="cpu", **base))


@pytest.mark.parametrize("k_runs", [2, 3])
def test_batched_matches_per_partition(k_runs):
    """8 partitions, two shape signatures (two dispatches)."""
    ref_jobs, port_jobs = make_jobs(
        [(100 + p, 400 if p < 6 else 700, p) for p in range(8)], k_runs)
    check(ref_jobs, port_jobs, *_opts())


def test_batched_per_partition_split_gc_mask():
    """pidx is per row: with a partition mask, each row drops exactly the
    keys its own partition no longer owns."""
    ref_jobs, port_jobs = make_jobs([(7, 400, 0), (7, 400, 1)])
    outs = check(ref_jobs, port_jobs, *_opts(partition_mask=1))
    assert outs[0].n and outs[1].n
    assert all(h & 1 == 0 for h in outs[0].hash32.tolist())
    assert all(h & 1 == 1 for h in outs[1].hash32.tolist())


def test_batched_applies_user_rules_and_default_ttl():
    ref_o, o = _opts(default_ttl=500)
    ref_o = replace(ref_o, user_ops=tuple(
        ref_rules.parse_user_specified_compaction(RULES)))
    o = replace(o, user_ops=tuple(
        port_rules.parse_user_specified_compaction(RULES)))
    ref_jobs, port_jobs = make_jobs([(60 + p, 300, p) for p in range(3)])
    outs = check(ref_jobs, port_jobs, ref_o, o)
    for got in outs:
        assert (got.expire_ts[~got.deleted] > 0).all()


def test_batched_post_opts_per_job():
    """Per-job post passes: alternate jobs carry the rules or a
    default_ttl; partition_mask and bottommost broadcast from opts."""
    ref_o, o = _opts(partition_mask=3)
    ref_ops = tuple(ref_rules.parse_user_specified_compaction(RULES))
    port_ops = tuple(port_rules.parse_user_specified_compaction(RULES))
    ref_post = [RefOptions(now=60, user_ops=ref_ops) if p % 2 else
                RefOptions(now=60, default_ttl=90) for p in range(4)]
    post = [CompactOptions(now=60, user_ops=port_ops) if p % 2 else
            CompactOptions(now=60, default_ttl=90) for p in range(4)]
    ref_jobs, port_jobs = make_jobs([(70 + p, 400, p) for p in range(4)])
    check(ref_jobs, port_jobs, ref_o, o, post, ref_post)


def test_batched_chunks_oversized_groups(monkeypatch):
    """A group over max_device_records splits into several dispatches."""
    groups = []
    real = batched_compact._run_group
    monkeypatch.setattr(batched_compact, "_run_group",
                        lambda jobs, idxs, *a, **k:
                        groups.append(list(idxs)) or real(jobs, idxs, *a,
                                                          **k))
    ref_jobs, port_jobs = make_jobs([(80 + p, 400, p) for p in range(6)])
    per_job = sum(d.padded_len for d in port_jobs[0][1])
    check(ref_jobs, port_jobs, *_opts(max_device_records=2 * per_job + 100))
    assert groups == [[0, 1], [2, 3], [4, 5]]


def test_single_job_over_budget_goes_blockwise(monkeypatch):
    calls = []
    from pegasus_tpu_torch.ops import compact

    real = compact._compact_blockwise
    monkeypatch.setattr(compact, "_compact_blockwise",
                        lambda *a: calls.append(1) or real(*a))
    ref_jobs, port_jobs = make_jobs([(90, 400, 0), (91, 3000, 1)],
                                    hk_space=5000)
    ref_o, o = _opts(max_device_records=2500)
    compact_partition_batch(port_jobs, o)
    assert len(calls) == 1
    check(ref_jobs, port_jobs, ref_o, o)


def test_mesh_is_not_ported():
    _, port_jobs = make_jobs([(5, 300, 0)])
    with pytest.raises(NotImplementedError, match="mesh"):
        compact_partition_batch(port_jobs, _opts()[1], mesh=object())


def test_uncached_run_rejected():
    _, port_jobs = make_jobs([(5, 300, 0)])
    runs, drs, pidx = port_jobs[0]
    with pytest.raises(ValueError, match="device-cached"):
        compact_partition_batch([(runs, [drs[0], None], pidx)], _opts()[1])


# ------------------------------------------------ batched plain merge


@pytest.mark.parametrize("name", [n for n, *_ in
                                  chip_smoke.batched_kernel_cases()])
def test_batched_plain_merge_matches_rows(name):
    a, b, nk = next((a, b, nk) for n, a, b, nk in
                    chip_smoke.batched_kernel_cases() if n == name)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = merge_two_sorted(ta, tb, nk)
    splits = merge_path_splits(ta, tb, nk)
    assert got.shape == (a.shape[0], a.shape[1], a.shape[2] + b.shape[2])
    for r in range(a.shape[0]):
        assert torch.equal(got[r], merge_two_sorted_plain(ta[r], tb[r], nk))
        assert torch.equal(splits[r], merge_path_splits_plain(ta[r], tb[r],
                                                              nk))
        assert torch.equal(splits[r], chip_smoke.merged_splits(ta[r], tb[r],
                                                               nk))
        cat = np.concatenate([a[r], b[r]], axis=1)
        order = np.lexsort(tuple(cat[c] for c in range(nk - 1, -1, -1)))
        np.testing.assert_array_equal(got[r, :nk].numpy(), cat[:nk, order])


def test_rows_differing_in_one_part_merge_differently():
    """The cross-row cases have teeth: their rows' merges differ, so a
    kernel tile that read a neighbouring row's columns would be caught."""
    for name, a, b, nk in chip_smoke.batched_kernel_cases():
        if "differ" not in name:
            continue
        got = merge_two_sorted(torch.from_numpy(a), torch.from_numpy(b), nk)
        for r in range(1, a.shape[0]):
            assert not torch.equal(got[r], got[r - 1]), name


def test_batched_merge_rejects_bad_operands():
    a = torch.zeros((2, 3, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="equal B"):
        merge_two_sorted(a, torch.zeros((3, 3, 5), dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="n_cols"):
        merge_two_sorted(a, torch.zeros((3, 5), dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="nk"):
        merge_two_sorted(a, a, 4)
