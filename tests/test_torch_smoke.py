"""chip_smoke.py rehearsed on the CPU at a tiny size.

The script itself refuses to run without a CUDA device; its phases are
functions, and here they run on device="cpu" (the plain merge in place of
the kernel): the fill, the engine compaction held against the cpu
backend's digest, the batched reads held against the host walk, the
blockwise compaction at depth 1 and 2, the batched compaction after a
partition split, the compaction offload service with its tenants, and
the server entry point as a subprocess. The kernel cases are held
against a numpy lexsort of the same rows.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pegasus_tpu_torch.ops.merge_path import merge_two_sorted


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main() is the whole run")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_kernel_cases_are_sorted_merges():
    for name, a, b, nk in chip_smoke.kernel_cases():
        got = merge_two_sorted(torch.from_numpy(a), torch.from_numpy(b),
                               nk).numpy()
        cat = np.concatenate([a, b], axis=1)
        order = np.lexsort(tuple(cat[c] for c in range(nk - 1, -1, -1)))
        np.testing.assert_array_equal(got[:nk], cat[:nk, order], name)
        assert sorted(got[nk].tolist()) == sorted(cat[nk].tolist()), name


def test_mixed_width_cases_are_sorted_merges():
    """The kernel phase's mixed-width cases (nk 4 and 10, one pair per
    thread) merge to a numpy lexsort of the same rows."""
    cases = chip_smoke.mixed_width_cases()
    assert sorted({nk for _, _, _, nk in cases}) == [4, 10]
    for name, a, b, nk in cases:
        got = merge_two_sorted(torch.from_numpy(a), torch.from_numpy(b),
                               nk).numpy()
        cat = np.concatenate([a, b], axis=1)
        order = np.lexsort(tuple(cat[c] for c in range(nk - 1, -1, -1)))
        np.testing.assert_array_equal(got[:nk], cat[:nk, order], name)


def test_engine_phases_at_tiny_size(tmp_path):
    runs = chip_smoke.fill(8000)
    assert len(runs) == 4 and all(r.n > 0 for r in runs)
    want, _ = chip_smoke.cpu_digest(runs)
    eng, rep = chip_smoke.run_compaction(str(tmp_path / "db"), runs, "cpu",
                                         want)
    try:
        assert rep["records_in"] == sum(r.n for r in runs)
        assert rep["records_out"] == rep["digest"]["records"] > 0
        assert rep["primed_runs"] == 4
        assert {"device", "gather", "sst_write"} <= set(rep["stages"])
        reads = chip_smoke.run_reads(eng, runs, n_puts=2000, n_gets=800,
                                     n_ranges=40)
        assert reads["gets"] == 800 and reads["get_hits"] > 0
        assert reads["range_rows"] > 0
    finally:
        eng.close()


def test_headroom_check_at_tiny_size(tmp_path):
    """The reads phase's headroom check on device="cpu": unpinned, the
    primes stop a run short at 7/8 of a budget one byte above the runs;
    pinned, every run is resident and the batched reads, each run probed
    on the device lanes, equal the cpu backend's (it raises otherwise)."""
    rep = chip_smoke.check_headroom("cpu", str(tmp_path), rows=300)
    assert rep["unpinned"]["runs"] == rep["runs"] - 1
    assert rep["cap_bytes"] <= rep["unpinned"]["bytes"] < rep["budget_bytes"]
    assert rep["pinned"] == dict(rep["pinned"], runs=rep["runs"],
                                 bytes=rep["budget_bytes"] - 1)
    assert rep["device_lookups"] == rep["runs"]
    assert rep["get_hits"] == 4096


def test_levels_phase_at_tiny_size(tmp_path):
    """The L0 + cascade phase at depths 1 and 2 on device="cpu", in two
    rounds: each level's files digest-equal to the cpu backend engine's
    after each round; depth 2 defers its installs into the compaction's
    job timeline."""
    opts = dict(chip_smoke.LEVELS_OPTS, target_file_size_bytes=48 << 10,
                level_base_bytes=192 << 10)
    rep = chip_smoke.run_levels(chip_smoke.fill(24000), "cpu",
                                str(tmp_path / "levels"), opts)
    assert rep["files"][1]["l0"] == 0 and set(rep["files"][1]) >= {"1", "2"}
    for d in (1, 2):
        rounds = rep[f"depth{d}"]["rounds"]
        # the second round's merge takes in the L1 files it overlaps
        assert rounds[0]["l0_records"] < rounds[1]["l0_records"]
        assert all(r["merges"] > 1 for r in rounds), "the cascade must run"
        assert rep[f"depth{d}"]["merge_launches"] == 0  # no card here
    one, two = rep["depth1"]["rounds"], rep["depth2"]["rounds"]
    assert [r["merges"] for r in one] == [r["merges"] for r in two]
    assert all(r["installs"] == 0 for r in one)
    assert all(r["installs"] == r["merges"] for r in two)
    assert rep["depth1"]["sst_write_s"] > 0


def test_check_lockrank_needs_an_armed_graph(tmp_path):
    """No violation file is not enough: every node must show recorded
    edges, and neither the file nor a node may hold a violation."""
    sink = tmp_path / "lockrank.jsonl"
    armed = {"replica1": {"lockrank.edges": 7, "lockrank.violations": 0}}
    assert chip_smoke.check_lockrank(str(sink), armed) == {
        "violations": 0, "edges": {"replica1": 7}}
    with pytest.raises(AssertionError, match="not armed"):
        chip_smoke.check_lockrank(str(sink), {})
    with pytest.raises(AssertionError, match="not armed"):
        chip_smoke.check_lockrank(str(sink), {
            **armed, "replica2": {"lockrank.edges": 0}})
    with pytest.raises(AssertionError, match="violations"):
        chip_smoke.check_lockrank(str(sink), {
            "replica1": {"lockrank.edges": 7, "lockrank.violations": 1}})
    sink.write_text('{"cycle": ["a", "b", "a"]}\n')
    with pytest.raises(AssertionError, match="violations"):
        chip_smoke.check_lockrank(str(sink), armed)


@pytest.mark.parametrize("argv", [[], ["fence-ab"], ["level-ab", "t"],
                                  ["serve-measure", "a", "b"],
                                  ["serve-run", "t"]])
def test_ab_modes_refuse_bad_arguments(argv, capsys):
    assert chip_smoke.ab_main(argv) == 2
    assert "usage" in capsys.readouterr().err


def test_value_residency_phase_at_tiny_size(tmp_path):
    runs = chip_smoke.fill(8000)
    want, _ = chip_smoke.cpu_digest(runs)
    eng, rep = chip_smoke.run_compaction(str(tmp_path / "db"), runs, "cpu",
                                         want, device_values=True)
    try:
        assert rep["digest"] == want and want["records"] > 0
        # the output's values were gathered from the resident value rows
        assert rep["stages"]["gather"]["bytes"] > 0
        ssts = eng._all_ssts_locked()
        assert ssts and all(s._device_run.val2d is not None for s in ssts)
    finally:
        eng.close()


def _skips_by_window_ends(a, b, nk):
    """Per tile, the leading key columns in which the first and last rows
    of both non-empty input windows agree, walked row by row."""
    from pegasus_tpu_torch.ops.merge_path import (TILE,
                                                  merge_path_splits_plain)

    splits = merge_path_splits_plain(a, b, nk).tolist()
    total = a.shape[1] + b.shape[1]
    skips = []
    for t in range(len(splits) - 1):
        d0, d1 = t * TILE, min((t + 1) * TILE, total)
        a0, a1 = splits[t], splits[t + 1]
        b0, b1 = d0 - a0, d1 - a1
        rows = ([a[:nk, i] for i in (a0, a1 - 1) if a1 > a0]
                + [b[:nk, j] for j in (b0, b1 - 1) if b1 > b0])
        k = 0
        while k < nk and all(r[k] == rows[0][k] for r in rows):
            k += 1
        skips.append(k)
    return float(np.mean(skips)) if skips else 0.0


@pytest.mark.parametrize("name", [n for n, *_ in chip_smoke.kernel_cases()])
def test_skipped_key_columns_match_window_ends(name):
    a, b, nk = next((a, b, nk) for n, a, b, nk in chip_smoke.kernel_cases()
                    if n == name)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert chip_smoke.skipped_key_columns(ta, tb, nk) == \
        pytest.approx(_skips_by_window_ends(ta, tb, nk))


@pytest.mark.parametrize("col_bytes", [4, 8])
def test_merge_bound_counts_the_columns_a_merge_needs(col_bytes):
    """No skipped column: 9 columns read and 9 written. Every key column
    skipped: the payload read and 9 columns written. Bytes bind."""
    la = lb = 1 << 20
    full, by = chip_smoke.merge_bound(la, lb, 9, 8, 0.0, col_bytes)
    assert by == "bytes"
    assert full == pytest.approx(
        18 * col_bytes * (la + lb) / chip_smoke.PEAK_BYTES_S * 1e3)
    none, _ = chip_smoke.merge_bound(la, lb, 9, 8, 8.0, col_bytes)
    assert none == pytest.approx(full * 10 / 18)
    half, _ = chip_smoke.merge_bound(la, lb, 9, 8, 5.0, col_bytes)
    assert none < half < full


def test_timed_batched_operands_are_sorted_rows():
    a, b = chip_smoke.timed_batched_operands(batch=3, rows=4096)
    assert a.shape == b.shape == (3, 9, 4096)
    for x in (a, b):
        for r in range(3):
            keys = [tuple(x[r, :8, i]) for i in range(4096)]
            assert keys == sorted(keys)
    got = merge_two_sorted(torch.from_numpy(a), torch.from_numpy(b), 8)
    assert got.shape == (3, 9, 8192)


def test_blockwise_phase_at_tiny_size():
    """A budget that forces three ranges; both depths digest-equal to
    the cpu backend (run_blockwise raises otherwise)."""
    runs = chip_smoke.fill(8000)
    want, _ = chip_smoke.cpu_digest(runs)
    rep = chip_smoke.run_blockwise(runs, "cpu", want, 3000)
    for depth in (1, 2):
        d = rep[f"depth{depth}"]
        assert d["ranges"] == 3 and d["digest"] == want
        assert {"pack", "h2d", "device", "gather"} <= set(d["stages"])
    assert rep["depth2"]["overlap_s"] > 0.0


def test_batched_phase_at_tiny_size():
    """A split into 4 partitions (B = 4): every output digest-equal to the
    cpu backend on its job with its own post options (run_batched raises
    otherwise), half the rows dropped as the sibling's, the rules of the
    first half applied."""
    runs = chip_smoke.fill(8000)
    jobs = chip_smoke.split_jobs(runs, "cpu", 4)
    assert [p for _, _, p in jobs] == [0, 1, 2, 3]
    assert jobs[0][1] is jobs[2][1]  # siblings share their parent's runs
    post = chip_smoke.split_post_opts(jobs)
    assert post[0].user_ops and not post[0].default_ttl
    assert post[3].default_ttl and not post[3].user_ops
    rep = chip_smoke.run_batched(jobs, post, "cpu")
    assert rep["digests_equal"] and rep["partitions"] == 4
    assert 0 < rep["records_out"] < rep["records_in"] * 0.6
    assert {"h2d", "device", "gather"} <= set(rep["stages"])
    assert len(rep["operands"]) >= 3


def test_tenth_prefix_holds_about_a_tenth():
    runs = chip_smoke.fill(40_000)
    prefix = chip_smoke.tenth_prefix(runs)
    hks = [runs[0].key(i)[2:18] for i in range(runs[0].n)]
    share = sum(h.startswith(prefix) for h in hks) / len(hks)
    assert prefix.startswith(b"userhash") and 0.05 <= share <= 0.2


def test_device_stage_phase_keeps_each_merge_as_two_d_operands(monkeypatch):
    """The single merge runs as a batch of one; the phase times each of
    its three merges on their [n_cols, L] operands."""
    runs = chip_smoke.fill(8000)
    seen = []
    monkeypatch.setattr(chip_smoke, "_time_merge",
                        lambda a, b, nk: seen.append((a.dim(), b.dim(), nk))
                        or {"ms": 0.0})
    rep = chip_smoke.profile_device_stage(runs, "cpu")
    assert seen == [(2, 2, 8)] * 3
    assert 0 < rep["survivors"] <= sum(r.n for r in runs)


def test_offload_phase_at_tiny_size(tmp_path):
    """The service from its ini on device="cpu": the first job (one
    partition of the 16-way split) digest-equal to the cpu backend, the
    repeat shipping nothing, two concurrent tenants each equal to their
    own cpu merge (run_offload raises otherwise)."""
    runs = chip_smoke.fill(8000)
    part = chip_smoke.partition_runs(runs, chip_smoke.OFFLOAD_PARTS)[
        chip_smoke.OFFLOAD_JOB_PART]
    want, _ = chip_smoke.cpu_digest(part)
    rep = chip_smoke.run_offload(runs, "cpu", str(tmp_path))
    assert rep["job_records"] == sum(r.n for r in part) < 8000
    job = rep["job"]
    assert job["digest"] == want and job["shipped_runs"] == 4
    assert job["shipped_bytes"] > 0 and job["fetched_bytes"] > 0
    assert set(job["spans_s"]) == {"offload.ship", "offload.merge",
                                   "offload.fetch"}
    assert set(job["service_s"]) == {"load_s", "merge_s", "publish_s"}
    assert rep["again"]["shipped_bytes"] == 0
    assert rep["again"]["skipped_runs"] == 4
    assert len(rep["two_tenants"]["rounds"]) == 2
    assert rep["status"]["merges_done"] == 4
    assert rep["status"]["running_merges"] == 0


def test_server_phase_at_tiny_size(tmp_path):
    """The entry point as a subprocess (device = cpu): boots, answers
    offload-status, merges one partition, exits 0 on SIGTERM."""
    runs = chip_smoke.fill(8000)
    rep = chip_smoke.run_server(runs, "cpu", str(tmp_path))
    assert rep["rc"] == 0 and rep["status"]["free_slots"] == 2
    assert rep["round"]["records_out"] > 0


def test_serve_phase_at_tiny_size(tmp_path):
    """The partition data plane on device="cpu": raw sets bulk-loaded into
    4 partitions through RPC_BULK_LOAD_INGEST, a zipfian 50/50 run from 4
    client threads (every read the loaded or an issued value), read-back
    of every updated key and a sample of untouched keys before a manual
    compaction of every partition through update_app_envs, of every
    updated key after it, each
    partition's ingested run and compaction output held to the cpu
    backend (run_serve raises on any mismatch)."""
    rep = chip_smoke.run_serve("cpu", str(tmp_path), n_records=6000,
                               n_parts=4, n_ops=600, n_threads=4,
                               n_sample=300)
    assert rep["ingested_records"] == 6000
    assert rep["ingest_check_s"] > 0 and rep["compaction"]["check_s"] > 0
    assert rep["run"]["ops_done"] == 600 and rep["run"]["keys_updated"] > 0
    assert rep["compaction"]["l0_files_after"] == 0
    # the untouched sample is read once, after the run (the second
    # read-back's sample is cut for the chip clock)
    for tag, sampled in (("read_back_after_run", 300),
                         ("read_back_after_compaction", 0)):
        assert rep[tag]["sampled_keys"] == sampled
        assert rep[tag]["updated_keys"] == rep["run"]["keys_updated"]
        assert rep[tag]["server_gc_pauses"]["count"] >= 0


@pytest.mark.parametrize("where", ["ingest", "compaction"])
def test_serve_phase_holds_merges_to_the_cpu_backend(tmp_path, monkeypatch,
                                                     where):
    """One value byte flipped in the run an ingest or a manual compaction
    installs (the updated and sampled keys may all miss it) fails the
    serve phase's cpu-backend check of that step."""
    from pegasus_tpu_torch.engine.db import LsmEngine

    def flip(block):
        block.val_arena = block.val_arena.copy()
        block.val_arena[len(block.val_arena) // 2] ^= 1

    if where == "ingest":
        install = LsmEngine.install_ingested_block

        def patched(self, block):
            flip(block)
            return install(self, block)

        monkeypatch.setattr(LsmEngine, "install_ingested_block", patched)
        match = "ingested run"
    else:
        install = LsmEngine._install_merge_output

        def patched(self, newer, older, out_block, target_level):
            flip(out_block)
            return install(self, newer, older, out_block, target_level)

        monkeypatch.setattr(LsmEngine, "_install_merge_output", patched)
        match = "manual compaction"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.run_serve("cpu", str(tmp_path), n_records=3000, n_parts=2,
                             n_ops=0, n_threads=1, n_sample=0)


def test_ycsb_key_names():
    """YCSB's hashed key names (fnvhash64, Java's Math.abs): the first
    key of every YCSB load is user6284781860667377211; the vectorized and
    scalar forms agree, and the loaded values are 100 bytes."""
    ranks = np.array([0, 1, 7, 123456, 9_999_999, 1 << 40], np.int64)
    rows, lens = chip_smoke.ycsb_hash_keys(ranks)
    assert chip_smoke.hash_key(0) == b"user6284781860667377211"
    for i, r in enumerate(ranks.tolist()):
        assert rows[i, :lens[i]].tobytes() == chip_smoke.hash_key(r)
        assert chip_smoke.loaded_values(ranks)[i].tobytes() == \
            chip_smoke.loaded_value(r)
        assert len(chip_smoke.loaded_value(r)) == 100
    z, rng = chip_smoke.ZipfRanks(1000), np.random.default_rng(3)
    picks = [z.pick(rng) for _ in range(2000)]
    assert min(picks) == 0 and max(picks) < 1000
    assert picks.count(0) > picks.count(500)


def test_replicate_phase_at_tiny_size(tmp_path):
    """PacificA on device="cpu": two 3-replica groups bulk-loaded through
    PacificA from the serve table's raw sets, a zipfian 50/50 run from 4
    threads with group 0's primary killed and restarted as a learner
    under load (writes commit throughout), every acknowledged update and
    a sample of loaded keys read back from every replica, digests equal
    within each group, and every replica's manual compaction held to the
    cpu backend (run_replicate raises on any mismatch)."""
    provider = str(tmp_path / "provider")
    chip_smoke.write_provider(provider, "usertable", 8000, 4,
                              chip_smoke.SERVE_FILES)
    rep = chip_smoke.run_replicate("cpu", str(tmp_path / "rep"), provider,
                                   n_records=8000, n_parts=4, n_groups=2,
                                   n_ops=1200, n_threads=4, n_sample=300,
                                   kill_at=300, restart_at=600)
    assert rep["run"]["ops_done"] == 1200
    assert rep["run"]["group0_acks_while_down"] > 0
    assert rep["run"]["group0_acks_during_learn"] > 0
    assert rep["run"]["learn"]["replay_mutations"] > 0
    rb = rep["read_back"]
    assert rb["keys"] == 3 * (rb["updated_keys"] + rb["sampled_keys"])
    assert rb["sampled_keys"] == 300 and rb["device_lookup_calls"] > 0
    assert rb["batch_size"]["p50"] > 1
    assert set(rep["digests"]["records"]) == {0, 1}
    assert len(rep["compaction"]["runs"]) == 6
    # the learner replays the ingest decree from the log tail (the
    # checkpoint's durable decree does not cover it): one run more
    assert rep["compaction"]["expected_launches"] == 7


def test_cluster_phase_at_tiny_size(tmp_path):
    """The cluster phase with every process on device="cpu": a meta and
    three replica processes booted from an ini derived from onebox.ini,
    a 4-partition table bulk-loaded through PacificA (every replica's run
    held to the cpu backend), a 50/50 run from 4 threads with the node
    leading the most partitions SIGKILLed, failed over (a 2 s grace),
    restarted and relearned, every acknowledged update and a sample read
    back, every primary's manual compaction held to the cpu backend, and
    all 12 replicas' audit digests equal (run_cluster raises on any
    mismatch); every process exits 0."""
    provider = str(tmp_path / "provider")
    counts = chip_smoke.write_provider(provider, "usertable", 6000, 4,
                                       chip_smoke.SERVE_FILES)
    rep = chip_smoke.run_cluster(
        "cpu", str(tmp_path / "cluster"), provider, counts, n_records=6000,
        n_parts=4, n_ops=1200, n_threads=4, n_sample=300, kill_at=300,
        restart_at=700, fd={"beacon_interval_seconds": 0.2,
                            "grace_seconds": 2,
                            "check_interval_seconds": 0.5})
    run = rep["run"]
    assert run["ops_done"] == 1200 and run["retries"] > 0
    assert run["victim_led_partitions"] >= 1
    # the grace runs from the victim's last beacon, up to one beacon
    # interval before the kill
    assert run["failover_s"] is not None and run["failover_s"] >= 1.5
    assert run["learn"]["tail_mutations_replayed"] > 0
    assert rep["read_back"]["sampled_keys"] == 300
    assert rep["audit"]["replicas"] == 12
    assert set(rep["stop_rcs"].values()) == {0}
    # the runtime planes through the port's shell, lock order checked
    assert rep["traces"]["slow_stage"] == "plog.append"
    assert len(rep["traces"]["spans_by_node"]) == 3
    assert rep["tables"]["write_qps"] >= run["keys_updated"]
    assert all("device" in st for st in
               rep["compaction"]["planes"]["compact_trace_stages"].values())
    assert rep["lockrank"]["violations"] == 0
    assert len(rep["lockrank"]["edges"]) == 3
    assert min(rep["lockrank"]["edges"].values()) > 0
    # the doctor named the killed node; healthy after the audit, its
    # audit evidence over every partition (run_cluster raises otherwise)
    assert rep["doctor_down"]["verdict"] != "healthy"
    assert rep["doctor_down"]["dead"] == [
        n for n in rep["doctor_down"]["dead"] if n.startswith("127.0.0.1:")]
    assert len(rep["doctor_down"]["dead"]) == 1
    assert rep["doctor"]["audit_checked"] == 4
    assert rep["doctor"]["shell"].startswith("cluster verdict: ")
    # the scheduler's tokens: partition 0 deferred on its primary past
    # the trigger, then lifted; urgent replicas compacted on every node
    sched = rep["sched"]
    assert sched["decisions"]["defer"] == 1 and sched["decisions"]["urgent"]
    assert sched["hot_l0_held"] >= chip_smoke.SCHED_TRIGGER
    assert sched["lift"]["l0_after"] == 0
    assert all(n > 0 for n in sched["urgent_tokens"].values())
    assert all(j["urgent"] >= sched["urgent_tokens"][n]
               for n, j in sched["urgent_jobs"].items())
    # the collector role: the hammered hash key's verdict pinned its
    # partition, every run of the primary's node resident (the cuda
    # backend's plain versions on the CPU), calmed and released; the
    # canary sampled through the kill and the restart
    res = rep["residency"]
    assert res["verdict"] == repr(res["hash_key"].encode())
    assert res["partition"] not in res["pinned_before"]
    assert res["resident_ssts"] >= res["primary_ssts"] > 0
    assert res["resident_bytes"][1] > res["resident_bytes"][0]
    assert res["hot_reads"]["batches"] > 0
    assert res["calming_reads"]["batches"] > 0
    col = rep["collector"]
    assert set(col["availability"]) == {"at_kill", "after_restart", "end"}
    assert all(a["samples"] > 0 for a in col["availability"].values())
    assert col["slo"]["usertable"]["verdict"] in ("ok", "warn", "burning")
    assert set(col["app_stat"]) == {"get_qps", "put_qps", "multi_get_qps",
                                    "scan_qps", "recent_read_cu",
                                    "recent_write_cu"}
    assert col["doctor"]["verdict"] in ("healthy", "degraded")


def test_cluster_lifecycle_at_tiny_size(tmp_path):
    """The cluster phase's table lifecycle with every process on
    device="cpu": the table created and bulk-loaded through the port's
    shell (a session), the run with its kill and restart, a cold backup,
    a 4 -> 8 split while two writers keep updating (every acknowledged
    write kept), the GC compaction of every replica (each primary held
    to the cpu backend under mask 7, owning only its keys, the
    primaries' records summing to the table's), the read-back through 8
    partitions, all 24 replicas' audit digests equal, the heal leg as
    main() runs it (600 rows: a flipped SST scrubbed, quarantined, its
    device bytes released and the doctor degraded, re-seeded and read
    back from 3 replicas; a planted audit mismatch auto-healed by the
    collector, its incident's first cause the fail point's arm), the
    restore into a new table read back with the backup-time values, and
    the restored table's node compaction through the batched path, each
    replica held to the cpu backend (run_cluster raises on any
    mismatch)."""
    provider = str(tmp_path / "provider")
    counts = chip_smoke.write_provider(provider, "usertable", 6000, 4,
                                       chip_smoke.SERVE_FILES)
    rep = chip_smoke.run_cluster(
        "cpu", str(tmp_path / "cluster"), provider, counts, n_records=6000,
        n_parts=4, n_ops=1200, n_threads=4, n_sample=300, kill_at=300,
        restart_at=700, fd={"beacon_interval_seconds": 0.2,
                            "grace_seconds": 2,
                            "check_interval_seconds": 0.5}, lifecycle=True,
        heal=True, heal_rows=600)
    life = rep["lifecycle"]
    assert "4/4 partitions, 6000 records" in rep["load"]["session"]
    assert life["backup"]["bytes"] > 0
    split = life["split"]
    assert split["partitions"] == 8 and split["writers"]["ops"] > 0
    assert split["seed_s"]["primary"]["learns"] == 4
    assert split["seed_s"]["secondary"]["learns"] == 8
    assert rep["compaction"]["partition_mask"] == 7
    assert rep["compaction"]["gc_dropped_rows"] > 0
    # the split read-back reads the updated keys (its sample is cut for
    # the chip clock)
    assert life["split_read_back"]["updated_keys"] > 0
    assert life["split_read_back"]["sampled_keys"] == 0
    assert rep["audit"]["replicas"] == 24
    assert rep["doctor"]["audit_checked"] == 8
    assert rep["sched"]["lift"]["l0_after"] == 0
    assert life["restore"]["read_back"]["sampled_keys"] > 0
    assert sum(s["batched"] for s in
               life["node_compaction"]["stats"].values()) == 12
    assert set(rep["stop_rcs"].values()) == {0}
    heal = rep["heal"]
    scrub, auto = heal["scrub"], heal["autoheal"]
    assert "crc32 mismatch" in scrub["finding"]
    assert scrub["resident_bytes_fell"] > 0
    before, quarantined, after = scrub["resident_bytes"]
    assert quarantined < before and after > quarantined
    assert scrub["doctor"]["verdict"] == "degraded"
    assert scrub["doctor"]["incident"]
    for leg in (scrub, auto):
        assert leg["audit"]["replicas"] == 12
        assert leg["read_back"] == dict(leg["read_back"], rows=600,
                                        replicas=3)
    assert auto["doctor"]["verdict"] == "critical"
    assert auto["doctor"]["autoheal"] == [{"gpid": auto["gpid"],
                                           "node": auto["victim"]}]
    assert auto["incident"]["id"] == auto["doctor"]["incident"]
    assert (auto["incident"]["first_cause"], auto["incident"]["point"],
            auto["incident"]["node"]) == ("failpoint.arm", "audit.digest",
                                          auto["victim"])


def test_geo_phase_at_tiny_size(tmp_path):
    """The geo phase on device="cpu" at 4 000 points, the box shrunk to
    keep the full run's density: both tables bulk-loaded (each run held
    to the cpu backend), moves and adds through GeoClient, both rounds of
    searches equal to the brute force with their range bounds resolved
    by the device path (the plain version here), the bottommost
    compaction held to the cpu backend, and the RESP session's every
    reply the expected bytes (run_geo raises on any mismatch)."""
    n = 4000
    rep = chip_smoke.run_geo(
        "cpu", str(tmp_path), n_points=n, n_moves=40, n_adds=20,
        searches=((500.0, -1, 24), (5000.0, 100, 4)), n_threads=2,
        box=chip_smoke.GEO_BOX * (n / chip_smoke.GEO_POINTS) ** 0.5,
        resp={"n_keys": 40, "n_members": 200, "n_geo": 4})
    assert rep["rows"] == 2 * n
    for rnd in ("search_before_compaction", "search_after_compaction"):
        r = rep[rnd]
        assert r["device_range_calls"] > 0
        assert r["500m"]["count"] == 24 and r["5000m"]["count"] == 4
        assert r["500m"]["rows_per_query"] > 5
        assert r["5000m"]["rows_per_query"] == 100
    assert rep["compaction"]["check_s"] > 0
    assert rep["resp"]["commands"] == 40 * 6 + 2 + 3 * 4
    assert rep["resp"]["georadius_members_per_query"] > 1


def test_geo_checks_catch_a_wrong_answer():
    """The geo phase's checks raise on an answer that lost a row, holds a
    wrong distance or is not the nearest; and on a RESP reply that is not
    the expected bytes."""
    import io

    lat, lng = chip_smoke.geo_points(400, 3, box=0.01)
    hks = [b"p%07d" % i for i in range(400)]
    truth = chip_smoke.GeoTruth(lat, lng, [chip_smoke.geo_value(
        i, a, b) for i, (a, b) in enumerate(zip(lat.tolist(),
                                                 lng.tolist()))], hks)
    c = chip_smoke.GEO_CENTER
    want = truth.search(c[0], c[1], 600.0)
    assert len(want) > 3
    chip_smoke.check_geo_answer(list(reversed(want)), want, -1)
    for bad in (want[1:], [(want[0][0] + 1e-9,) + want[0][1:]] + want[1:]):
        with pytest.raises(AssertionError):
            chip_smoke.check_geo_answer(bad, want, -1)
    near = truth.search(c[0], c[1], 600.0, 3)
    with pytest.raises(AssertionError):
        chip_smoke.check_geo_answer(want[1:4], near, 3)

    class _Wire(io.BytesIO):
        def write(self, b):
            return len(b)

    wire = _Wire(b"+OK\r\n:7\r\n")
    allowed = {b":6\r\n", b":7\r\n"}
    assert chip_smoke._resp_exchange(wire, [(b"x", b"+OK\r\n"),
                                            (b"y", allowed)]) == 2
    with pytest.raises(AssertionError):
        chip_smoke._resp_exchange(_Wire(b"$1\r\n6\r\n"),
                                  [(b"x", b"$1\r\n7\r\n")])


_LEFTOVERS = """
import json, multiprocessing, os, subprocess, sys
sys.path.insert(0, {root!r})
import chip_smoke
from multiprocessing import resource_tracker

ctx = multiprocessing.get_context("spawn")
pool = ctx.Pool(1)
assert pool.apply(abs, (-2,)) == 2
progress = ctx.Value("q", 0)
stray = subprocess.Popen(["sleep", "60"])
tracker = resource_tracker._resource_tracker._pid
chip_smoke._stop_processes()
print(json.dumps({{"children": chip_smoke._child_pids(),
                  "tracker": tracker,
                  "tracker_alive": os.path.exists(f"/proc/{{tracker}}"),
                  "stray": stray.pid}}))
"""


def test_stop_processes_leaves_no_child_running(tmp_path):
    """The script's last act: a spawn pool never terminated and a stray
    child are ended and reaped, and so is the resource tracker the pool
    started, before the script exits (nothing of it outlives it)."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", _LEFTOVERS.format(root=chip_smoke.ROOT)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["tracker"] is not None
    assert got["children"] == [] and not got["tracker_alive"]
    assert f"stopping leftover child process {got['stray']}" in proc.stderr
    assert "leaked" not in proc.stderr
