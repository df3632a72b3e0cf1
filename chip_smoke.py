#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pegasus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py fence-ab TREE ... (the fence kernel of each
                                            checkout in turn; ab)
    python3 chip_smoke.py serve-ab TREE ... (the serve phase of each
                                            checkout in turn; ab)

Needs one CUDA device and the CUDA toolkit (nvcc); without a device it
exits non-zero before printing any result. Phases, one JSON line each:

  1. device   the card's name, and its name and power limit from nvidia-smi;
  2. build    compiles pegasus_tpu_torch/csrc/merge_path.cu and
              csrc/fence_lookup.cu at once (ops/_build.py, one nvcc
              each); ptxas's registers, shared memory and spills per
              kernel (a spill fails the run);
  3. kernel   the merge-path kernels against the plain PyTorch versions on
              the card: every merge byte-equal over every column, the
              partition pass equal to merge_path_splits_plain
              and to the splits of the plain merge's output, at the
              shapes of tests/test_pallas_merge.py, the tiled kernel's
              edge cases, and the compaction's own: a (4194304, 4194304)
              merge with nk=8 on random keys and on the bench keys'
              shared leading lanes, and a (8388608, 8388608) one, timed;
              then the batched form ([B, n_cols, L] operands) on
              batched_kernel_cases() against the plain batched merge
              and splits, and a (32, 131072+131072, nk=8) merge on the
              bench keys' heads timed beside 32 sequential 2-D calls;
              then the fence-lookup kernel byte-equal to its plain
              version (device_lookup.fence_lookup_plain) on
              lookup_probe_cases(), points and ranges, at the wrapper's
              lanes per query and at each of the kernel's, and timed on
              a serve partition's run (312 500 rows) at 64 and 4096
              queries (time_fence: the wrapper's calls, the kernel's own
              device time L2-warm and L2-cold, the wrapper's host time,
              the plain version, rounds per query, the probe's split);
     device_stage  the compaction's device stage alone on the bench runs
              (below), under torch.profiler: wall time, device busy time,
              device time by kernel; the three merges' own operands are
              kept, held kernels against plain versions, and timed;
  4. compact  bench.py's fill regenerated here (10M records in 4 sorted
              runs, 26-byte keys, 113-byte values, 10% expired TTLs, 5%
              tombstones, a 5M hashkey space), installed into a
              LsmEngine(backend="cuda"), primed onto the device, and
              manual_compact(now=100) under a device-only torch.profiler
              trace (device busy time and idle share of the whole call):
              the merge kernel must have launched, and the output's digest
              must equal the port's cpu backend's;
     compact_values  the same with EngineOptions(device_values=True):
              value rows resident too, the output's values gathered on the
              device, the same digest;
     levels   the engine's own L0 -> L1 compact() and its size-triggered
              cascade (1M records of the same fill, 8 MiB files, an L1
              budget of 32 MiB, ratio 4) in two rounds (the older two
              runs installed and compacted, then the newer two, whose
              merges meet the levels' files) at
              PEGASUS_COMPACT_PIPELINE_DEPTH 1 (synchronous installs) and
              2 (deferred installs), in turns 1, 2, 2, 1, every level's
              files digest-equal to the cpu backend engine's after each
              round; compact() seconds and the seconds until its async
              primes settled; from the compaction's job trace the
              engine.merge and engine.install hop seconds and the
              install seconds beside a merge;
  5. reads    200k write_batch puts + flush, get_batch of 100k keys (half
              hits, half misses) and 1000 scan_range_batch ranges, each
              equal to the host walk (get / scan), through the
              fence-lookup kernel (its launches counted); the kernel then
              checked and timed on the 10M-record compaction output
              (time_fence); then read residency's headroom
              (check_headroom): 16 equal runs on an engine whose budget
              is one byte above their bytes prime a run short of them at
              7/8 of it unpinned and all of them after
              set_read_residency(True), the pinned reads equal to the cpu
              backend's through the fence kernel;
  6. blockwise  the 10M runs through compact_blocks(backend="cuda",
              max_device_records=2^22): at least 3 key ranges, at
              PEGASUS_COMPACT_PIPELINE_DEPTH 1 and 2, each digest equal to
              the cpu backend's; stage spans, the pipeline's stall and
              overlap seconds, peak device memory;
  7. batched  the node-level compaction after a partition split: the 10M
              records cut into a 16-partition table by hash32 & 15, split
              to 32 partitions (partition_mask 31; child p takes parent
              p % 16's four runs, so half its rows are its sibling's),
              each run primed, one compact_partition_batch call with
              per-partition post options (half a user_specified_compaction
              spec, half a default_ttl) under torch.profiler: 3 merge
              calls over 96 batch rows by the launch counts, every
              partition's digest equal to the cpu backend's on its job;
              the same jobs one by one through compact_blocks; the batched
              merges' own operands timed against the plain batched merge
              and 32 sequential 2-D calls;
  8. offload  the compaction offload service in-process
              (runtime/service_app.CompactOffloadApp, backend = cuda, 2
              merge slots), its tenants the port's client over loopback
              RPC: the 10M-record job digest-equal to the cpu backend with
              its merge kernels launched on the service (3), under
              torch.profiler; two tenants at once (one partition each of a
              16-way split, one with a default_ttl, one with user rules),
              each digest-equal to its own cpu merge, and the first one's
              job again, shipping 0 bytes; per round its wall time, the
              offload.ship/merge/fetch spans, bytes and MB/s, the
              service's load/merge/publish seconds; the same runs through
              compact_blocks(backend="cuda") locally; device busy time over
              the service's merge and peak device memory;
  9. server   python -m pegasus_tpu_torch.server --config <ini> --app
              offload as a subprocess: boot, offload-status over
              RPC_CLI_CLI_CALL (backend cuda, 2 free slots), one partition
              digest-equal to its cpu merge, SIGTERM, exit 0;
 10. serve    the partition data plane at BASELINE config #3 (YCSB
              workload-A, 32 hash partitions): 32 PegasusServers (cuda
              backend) behind two in-process RpcServers; 10M records
              (hash key "user"+fnvhash64(rank), sort key field0, 100-byte
              value) bulk-loaded from 4 unsorted raw sets per partition,
              one RPC_BULK_LOAD_INGEST each (>= 32 merge-kernel launches),
              each partition's installed run digest-equal to the cpu
              backend's compaction of the same raw sets; 25k closed-loop
              ops from 8 PegasusClient threads, 50 % get,
              50 % set on zipfian ranks (theta 0.99), every read the loaded
              or an issued value; read-back of every updated key and a
              50k sample of untouched keys through batch dispatch (its
              batches above 1, device lookups made, each through the
              fence-lookup kernel); a manual
              compaction of every partition through update_app_envs
              (>= 32 launches) under torch.profiler, each output
              digest-equal to the cpu backend's compaction of the
              partition's runs from just before; the updated keys read
              back again (the untouched sample only once, after the run).
              Then (`fence_probe`) time_fence on the serve partition's
              run at the read-backs' batch size (read.batch.size p50).
 11. replicate  PacificA at BASELINE #3's per-partition scale: partition
              0 of the serve table, a ReplicaGroup of 3 replicas
              (cuda engines, quorum 2), loaded through PacificA with one
              RPC_BULK_LOAD_INGEST write (9 merge launches);
              YCSB-A, 10k ops from 8 threads (gets through
              primary.server.on_get_batch), group 0's primary killed at
              op 3.75k and restarted as a learner at op 6.25k (writes
              commit throughout); every acknowledged update and a 50k
              sample read back from every replica (fence-lookup launches
              counted); state digests equal; a manual
              compaction of all 3 replicas, each output digest-equal to
              the cpu backend's compaction of its runs.
 12. geo      BASELINE #5 (geo range-scan + compact) at tools/geo_bench.py's
              geography and levels (12/16): the geo client's two tables,
              geo_main and geo_idx, 8 partitions each, PegasusServers
              (cuda backend; geo_idx with a 9-lane key window and device
              reads from one range up, GEO_IDX_OPTS) behind two in-process
              RpcServers; 1 000 000 points uniform in +-0.7 deg around
              40.06 N 116.40 E (2 000 000 rows) bulk-loaded from 4 raw
              sets per partition, each run held to the cpu backend; through
              GeoClient from 8 threads, 5 000 points moved and 2 500
              added, then 500 radial searches of 500 m and 50 of 5 km
              (nearest 100), every answer equal to a brute force over the
              known points (haversine_m distances); a bottommost manual
              compaction of all 16 partitions, each output held to the cpu
              backend; the searches again; a RESP session over TCP to a
              RedisProxy (SET/GET/SETEX/TTL/INCRBY/DEL on 1 000 keys,
              GEOADD of 2 000 members, 20 each of GEORADIUS, GEODIST and
              GEOPOS), every reply the expected bytes. Merge launches around
              the ingest and the compaction, fence launches around each
              round of searches.
 13. cluster  BASELINE #3 with its three replicas as processes: an ini
              derived from onebox.ini (cluster_ini: one meta, replica1..3
              on fixed ports, replica1's http_port, compaction_backend =
              cuda, onebox's failure detector, and the collector, its
              round every second and its canary on onebox's `test`
              table), each app a `python -m pegasus_tpu_torch.server`
              subprocess on the card, the collector started once every
              node is alive. Through the port's shell
              (Shell.run_line; an error line raises): `create usertable
              -p 32 -r 3` and a bulk-load session (`start_bulk_load -a`,
              query_bulk_load_status to succeed: every replica ingests,
              288 merge launches), every replica's run digest-equal to
              the cpu backend's; 40k YCSB-A ops from 8 threads in a
              client process, the node leading the most partitions
              SIGKILLed at op 15k and restarted at op 25k once failed over
              (the meta re-adds it, it relearns over RPC_LEARN_*), no op
              failing for good; every acknowledged update and a 25k
              sample read back (fence-lookup launches scraped from the
              processes). Then the residency leg (check_residency): 256
              rows under one new hash key flushed into a run on each of
              its partition's replicas, read back in one batch over and
              over from the client process until the collector flags the
              partition, names that hash key by detect_hotkey on the
              primary and pins it (set-read-residency on); every SST of
              the primary's node then resident on the card and
              engine.hbm.resident_bytes grown; the hot reads launching
              the fence kernel on the primary, every answer the
              acknowledged value; reads of the other partitions then
              calm it and the pin is released. The collector's surfaces
              (check_collector): the canary's samples at the kill, after
              the restart and now; GET /metrics on replica1's http_port
              listing engine_hbm_resident_bytes; the shell's `slo
              <collector>`, `app_stat` and `slow_requests --cluster`.
              Then the runtime planes through the shell: a
              traced set's spans under one trace_id in every node's
              `request_trace`; `set_fail_point` arming a one-shot sleep on
              a secondary's plog group commit, its `slow_requests` naming
              plog.append; `tables` folding reads and writes to at least
              the acknowledged ops, device reads and resident bytes
              counted. The table lifecycle: `backup_app`; the split to
              64 partitions (RPC_CM_START_PARTITION_SPLIT) while 2 writers
              keep updating, each child seeded by a learn (seconds and
              bytes); the GC compaction of all 192 replicas through
              RPC_CM_SET_APP_ENVS, each primary's output digest-equal to
              the cpu backend's under mask 63, owning only its keys, the
              primaries' records summing to the table's (after it:
              `compact_trace` shows the device stages, `device_health`
              not wedged with a fresh last_ok, `job_trace` the manual
              compaction jobs); every
              acknowledged write (the run's and the split's) read back
              through 64 partitions; trigger-audit on
              every primary, query-audit on every replica: equal digests
              at an equal decree on all 192. Then the integrity loop
              (check_heal; the collector under PEGASUS_AUTOHEAL=1, its
              http_port and incident dir): a table `heal` of 4 x 3 with
              5 000 rows, flushed; the tail of one secondary's newest SST
              flipped with the meta frozen, the shell's scrub_replica
              quarantining it, that node's engine.hbm.resident_bytes down,
              the collector's doctor degraded naming it, the meta's tick
              re-seeding it once unfrozen, the bytes back, the audit
              conclusive, every row read back from all 3 replicas (fence
              launches counted); then audit.digest armed on another
              secondary, the audit's one mismatch, the collector's doctor
              critical with autoheal naming that replica and an incident
              whose first cause on GET /incidents is the arm (the shell's
              flight_recorder lists it), disarmed, re-seeded, re-audited,
              read back. `restore_app` into
              usertable_r (query_restore_status to ok), its read-back
              equal to the values at backup time; batched-manual-compact
              of usertable_r on every node (the batched merge kernel),
              each replica's output held to the cpu backend, its
              `job_trace` merge hops carrying the node's launch-count
              delta; every process stopped with SIGTERM, exit 0, having
              run under PEGASUS_LOCKRANK=1 with no lock-order violation
              in its file, and each replica node's acquisition graph
              (its lockrank.edges counter, read before the stop) not
              empty.

The main paths (compact, levels at each depth, blockwise, batched,
offload, serve's ingest and compaction, replicate's load and
compaction, geo's ingest and compaction; the reads of reads,
serve, replicate and geo's two rounds of searches) each run with the
launch counts set to 0 just before and read just after; the cluster
phase reads each process's counts (perf counters kernel.*) before and
after each of its steps: the bulk-load session, the read-backs (the heal
leg's too), the GC compaction and the restored table's node compaction.
Then, before the last line, the kernel table (times, launches, bounds,
launches by phase; merge_path, merge_path_batched and fence_lookup) and
the nvidia-smi line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises and exits non-zero. Engine and offload-service
files go to .scratch/chip_smoke/ under the repository and are removed at
the end; every phase line is also appended to
.scratch/chip_smoke_phases.jsonl.
"""

import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
# non-tensor 32-bit operation rate
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

N_RECORDS = 10_000_000
N_RUNS = 4
VALUE_SIZE = 100
TTL_FRAC = 0.10
DEL_FRAC = 0.05
NOW = 100
BLOCKWISE_BUDGET = 1 << 22   # max_device_records of the blockwise phase


# every phase line again, whole, beside the run's output (whose end is
# all a caller may get back)
PHASE_LOG = os.path.join(ROOT, ".scratch", "chip_smoke_phases.jsonl")


_STARTED = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the script's seconds so far (t_s)."""
    line = json.dumps({"phase": phase, **kw,
                       "t_s": time.perf_counter() - _STARTED})
    print(line, flush=True)
    os.makedirs(os.path.dirname(PHASE_LOG), exist_ok=True)
    with open(PHASE_LOG, "a") as f:
        f.write(line + "\n")


# ---------------------------------------------------------------- the fill

def make_run(n: int, value_size: int, seed: int, key_space: int):
    """bench.py's fillrandom run: n records, 16B hashkey + 8B sortkey, v2
    values, TTL_FRAC with an already-expired TTL, DEL_FRAC tombstones."""
    from pegasus_tpu_torch.base.crc64 import crc64_batch
    from pegasus_tpu_torch.engine.block import KVBlock

    rng = np.random.default_rng(seed)
    klen = 2 + 16 + 8
    keys = np.zeros((n, klen), dtype=np.uint8)
    keys[:, 0], keys[:, 1] = 0, 16  # u16 BE hashkey len
    hk_ids = rng.integers(0, key_space, size=n)
    digits = np.zeros((n, 16), np.uint8)
    v = hk_ids.copy()
    for j in range(15, 7, -1):
        digits[:, j] = 48 + (v % 10)
        v //= 10
    digits[:, :8] = np.frombuffer(b"userhash", dtype=np.uint8)
    keys[:, 2:18] = digits
    keys[:, 18:26] = rng.integers(0, 256, size=(n, 8), dtype=np.uint8)
    vlen = 13 + value_size  # v2 header + payload
    vals = rng.integers(0, 256, size=(n, vlen), dtype=np.uint8)
    vals[:, 0] = 0x82
    expire = np.zeros(n, np.uint32)
    with_ttl = rng.random(n) < TTL_FRAC
    expire[with_ttl] = rng.integers(1, 50, size=int(with_ttl.sum()),
                                    dtype=np.uint32)
    vals[:, 1] = (expire >> 24).astype(np.uint8)
    vals[:, 2] = (expire >> 16).astype(np.uint8)
    vals[:, 3] = (expire >> 8).astype(np.uint8)
    vals[:, 4] = expire.astype(np.uint8)
    vals[:, 5:13] = 0
    deleted = rng.random(n) < DEL_FRAC
    hashes = crc64_batch(keys.reshape(-1),
                         np.arange(n, dtype=np.int64) * klen + 2,
                         np.full(n, 16, np.int64))
    return KVBlock(
        key_arena=keys.reshape(-1),
        key_off=np.arange(n, dtype=np.int64) * klen,
        key_len=np.full(n, klen, np.int32),
        val_arena=vals.reshape(-1),
        val_off=np.arange(n, dtype=np.int64) * vlen,
        val_len=np.full(n, vlen, np.int32),
        expire_ts=expire,
        hash32=(hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        deleted=deleted)


def presort_run(block):
    """Order a fill run by key with first-wins dedup (SSTs are born
    sorted and unique)."""
    from pegasus_tpu_torch.ops.packing import pack_key_prefixes, pack_sbytes

    w = 7  # 26-byte keys -> ceil(26/4)
    pref = pack_key_prefixes(block.key_arena, block.key_off, block.key_len, w)
    sb = pack_sbytes([pref[:, j] for j in range(w)],
                     block.key_len.astype(np.uint32))
    order = np.argsort(sb, kind="stable")
    sb_sorted = sb[order]
    uniq = np.ones(len(order), dtype=bool)
    uniq[1:] = sb_sorted[1:] != sb_sorted[:-1]
    return block.gather(order[uniq])


def fill(n_total: int, n_runs: int = N_RUNS):
    """-> runs, newest first (bench.py's _fill: seeds 0.., key space n/2)."""
    return [presort_run(make_run(n_total // n_runs, VALUE_SIZE, seed=s,
                                 key_space=max(1, n_total // 2)))
            for s in range(n_runs)]


def block_digest(blocks) -> dict:
    """Record count + md5 over keys, values, expire and deleted, streamed
    over blocks in order (a split output digests as its whole)."""
    h = {k: hashlib.md5() for k in ("keys", "values", "expire", "deleted")}
    n = 0
    for b in blocks:
        n += b.n
        h["keys"].update(b.key_arena.tobytes())
        h["values"].update(b.val_arena.tobytes())
        h["expire"].update(np.ascontiguousarray(b.expire_ts).tobytes())
        h["deleted"].update(np.ascontiguousarray(b.deleted).tobytes())
    return {"records": n, **{k: v.hexdigest() for k, v in h.items()}}


def engine_blocks(path: str) -> list:
    """Every SST block of an engine directory, newest first (L0, then
    each level in key order), as the MANIFEST lists them on disk."""
    from pegasus_tpu_torch.engine.sstable import read_sst

    return [read_sst(f)[0] for f in engine_files(path)]


def engine_files(path: str) -> list:
    with open(os.path.join(path, "MANIFEST")) as f:
        m = json.load(f)
    names = list(m["l0"]) + [n for lv in sorted(m["levels"], key=int)
                             for n in m["levels"][lv]]
    return [os.path.join(path, n) for n in names]


def level_blocks(path: str, level: int) -> list:
    """The SST blocks of one level, in key order, as the MANIFEST lists
    them on disk."""
    from pegasus_tpu_torch.engine.sstable import read_sst

    with open(os.path.join(path, "MANIFEST")) as f:
        names = json.load(f)["levels"].get(str(level), [])
    return [read_sst(os.path.join(path, name))[0] for name in names]


# ------------------------------------------------------------ the kernel

def _operand(keys, nk, prio=0, idx_base=0, pad_rows=0):
    """[nk+1, n + pad_rows] int64 operand from nk sorted u32 key columns:
    the n real rows with idx idx_base.., then pad rows (keys 0xFFFFFFFF,
    last key column 0xFFFFFF00 | prio as in compaction, idx -1)."""
    n = len(keys[0])
    idx = np.arange(idx_base, idx_base + n, dtype=np.int64)[None]
    real = np.concatenate([np.stack(keys).astype(np.int64), idx])
    pad = np.full((nk + 1, pad_rows), 0xFFFFFFFF, dtype=np.int64)
    pad[nk - 1] = 0xFFFFFF00 | prio
    pad[nk] = -1
    return np.concatenate([real, pad], axis=1)


def _lexsorted(cols):
    order = np.lexsort(tuple(reversed(cols)))
    return [c[order] for c in cols]


def _sorted_operand(rng, n, nk, lo=0, hi=1 << 20, pad_rows=0, prio=0,
                    idx_base=0):
    """n real rows ascending over nk u32 key columns (the first drawn from
    [lo, hi), the rest random), then pad rows (see _operand)."""
    prim = rng.integers(lo, hi, size=n, dtype=np.uint32)
    rest = [rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            for _ in range(nk - 1)]
    return _operand(_lexsorted([prim] + rest), nk, prio, idx_base, pad_rows)


# the bench keys' leading lanes (bytes "\0\x10userhash" + two hashkey
# digits), plus lane-2 values with the high bit set
BENCH_HEADS = ([0x00107573], [0x65726861],
               [0x73683030, 0x73683031, 0x73683032, 0x80000000, 0xF3683030])


def _headed_operand(rng, n, nk, heads, pad_rows=0, prio=0, idx_base=0):
    """n real rows whose leading key columns are drawn from the value sets
    `heads` (shared key prefixes), the middle ones random, the last one
    26 << 8 | prio (compaction's klen<<8|prio for 26-byte keys); then pad
    rows (see _operand)."""
    cols = [rng.choice(np.asarray(h, dtype=np.uint32), size=n)
            for h in heads]
    cols += [rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
             for _ in range(nk - 1 - len(heads))]
    cols.append(np.full(n, (26 << 8) | prio, dtype=np.uint32))
    return _operand(_lexsorted(cols), nk, prio, idx_base, pad_rows)


def kernel_cases(seed: int = 0):
    """(name, a, b, nk) numpy operand pairs: the test_pallas_merge.py
    shapes and skews, pad-heavy runs, and nk = 2, 8, 10; bench-shaped
    shared prefixes; windows whose ends agree on one side only or on
    different values; run lengths 0, 1, around half a kernel tile and
    around one; an all-pad tile."""
    rng = np.random.default_rng(seed)
    cases = []
    for nk in (2, 8, 10):
        for la, lb in ((1, 5000), (5000, 1), (3000, 7001), (2048, 2048)):
            cases.append((f"interleaved la={la} lb={lb} nk={nk}",
                          _sorted_operand(rng, la, nk),
                          _sorted_operand(rng, lb, nk, prio=1,
                                          idx_base=la), nk))
        cases.append((f"disjoint nk={nk}",
                      _sorted_operand(rng, 4000, nk, 0, 1000),
                      _sorted_operand(rng, 4000, nk, 10_000, 11_000, prio=1,
                                      idx_base=4000), nk))
        cases.append((f"disjoint-reversed nk={nk}",
                      _sorted_operand(rng, 4000, nk, 10_000, 11_000),
                      _sorted_operand(rng, 4000, nk, 0, 1000, prio=1,
                                      idx_base=4000), nk))
        cases.append((f"equal-primary nk={nk}",
                      _sorted_operand(rng, 4096, nk, 5, 6),
                      _sorted_operand(rng, 4096, nk, 5, 6, prio=1,
                                      idx_base=4096), nk))
        cases.append((f"pad-heavy nk={nk}",
                      _sorted_operand(rng, 100, nk, pad_rows=4000),
                      _sorted_operand(rng, 3000, nk, pad_rows=96, prio=1,
                                      idx_base=100), nk))
    cases += edge_cases(rng)
    return cases


def edge_cases(rng):
    """The cases aimed at the tiled kernel (see kernel_cases)."""
    cases = []
    for nk, (la, lb) in ((8, (5000, 7000)), (10, (3000, 3000))):
        cases.append((f"bench-prefix la={la} lb={lb} nk={nk}",
                      _headed_operand(rng, la, nk, BENCH_HEADS,
                                      pad_rows=500),
                      _headed_operand(rng, lb, nk, BENCH_HEADS,
                                      pad_rows=300, prio=1,
                                      idx_base=la), nk))
    # A's windows agree in column 1 (always 5); B's span 4..6, or agree
    # on another value (always 6)
    cases.append(("one-side-agrees nk=8",
                  _headed_operand(rng, 6000, 8, ([7], [5])),
                  _headed_operand(rng, 6000, 8, ([7], [4, 5, 6]), prio=1,
                                  idx_base=6000), 8))
    cases.append(("sides-agree-apart nk=8",
                  _headed_operand(rng, 3000, 8, ([7], [5])),
                  _headed_operand(rng, 3000, 8, ([7], [6]), prio=1,
                                  idx_base=3000), 8))
    from pegasus_tpu_torch.ops.merge_path import TILE

    lens = [0, 1] + [t + k for t in (TILE // 2, TILE) for k in (-1, 0, 1)]
    for k, n in enumerate(lens):
        nk = (2, 8, 10)[k % 3]
        cases.append((f"run-length la={n} lb=1500 nk={nk}",
                      _sorted_operand(rng, n, nk),
                      _sorted_operand(rng, 1500, nk, prio=1, idx_base=n),
                      nk))
        cases.append((f"run-length la=1500 lb={n} nk={nk}",
                      _sorted_operand(rng, 1500, nk),
                      _sorted_operand(rng, n, nk, prio=1, idx_base=1500),
                      nk))
    cases.append(("all-pad nk=8",
                  _sorted_operand(rng, 0, 8, pad_rows=3000),
                  _sorted_operand(rng, 10, 8, pad_rows=5000, prio=1), 8))
    return cases


def batched_kernel_cases(seed: int = 2):
    """(name, a [B, n_cols, la], b [B, n_cols, lb], nk) numpy batched
    operand pairs: B = 1; B = 3 rows of different content (interleaved,
    disjoint, bench-shaped prefixes with pads); a row made wholly of pad
    rows beside a row with none; three rows whose key columns differ only
    from the rows above and below (the payload is the same in each), and
    three whose payloads differ only (the keys are the same): a tile that
    read another row's columns writes another row's bytes."""
    rng = np.random.default_rng(seed)
    cases = []
    for nk in (2, 8):
        cases.append((f"B=1 nk={nk}", _sorted_operand(rng, 3000, nk)[None],
                      _sorted_operand(rng, 5000, nk, prio=1,
                                      idx_base=3000)[None], nk))
    rows = [(_sorted_operand(rng, 4000, 8),
             _sorted_operand(rng, 4000, 8, prio=1, idx_base=4000)),
            (_sorted_operand(rng, 4000, 8, 0, 1000),
             _sorted_operand(rng, 4000, 8, 10_000, 11_000, prio=1,
                             idx_base=4000)),
            (_headed_operand(rng, 3500, 8, BENCH_HEADS, pad_rows=500),
             _headed_operand(rng, 3000, 8, BENCH_HEADS, pad_rows=1000,
                             prio=1, idx_base=3500))]
    cases.append(("B=3 mixed rows nk=8", np.stack([r[0] for r in rows]),
                  np.stack([r[1] for r in rows]), 8))
    pad = (_sorted_operand(rng, 0, 8, pad_rows=4096),
           _sorted_operand(rng, 0, 8, pad_rows=4096, prio=1))
    full = (_sorted_operand(rng, 4096, 8),
            _sorted_operand(rng, 4096, 8, prio=1, idx_base=4096))
    cases.append(("B=2 all-pad row beside a pad-free row nk=8",
                  np.stack([pad[0], full[0]]), np.stack([pad[1], full[1]]),
                  8))
    # the same payload under three different key orders: rows 0 and 2
    # put all of A after all of B, row 1 interleaves
    keyed = [(_sorted_operand(rng, 3000, 8, 10_000, 11_000),
              _sorted_operand(rng, 3000, 8, 0, 1000, prio=1)),
             (_sorted_operand(rng, 3000, 8),
              _sorted_operand(rng, 3000, 8, prio=1)),
             (_sorted_operand(rng, 3000, 8, 20_000, 21_000),
              _sorted_operand(rng, 3000, 8, 0, 1000, prio=1))]
    for x, y in keyed:
        x[8], y[8] = np.arange(3000), np.arange(3000, 6000)
    cases.append(("B=3 rows differ in key columns only nk=8",
                  np.stack([r[0] for r in keyed]),
                  np.stack([r[1] for r in keyed]), 8))
    a = _sorted_operand(rng, 3000, 8)
    b = _sorted_operand(rng, 3000, 8, prio=1)
    pa, pb = [], []
    for r in range(3):
        x, y = a.copy(), b.copy()
        x[8] = np.arange(3000) + 10_000 * r
        y[8] = np.arange(3000, 6000) + 10_000 * r
        pa.append(x)
        pb.append(y)
    cases.append(("B=3 rows differ in payload only nk=8", np.stack(pa),
                  np.stack(pb), 8))
    return cases


def timed_batched_operands(seed: int = 3, batch: int = 32,
                           rows: int = 131072, nk: int = 8):
    """(a, b) [batch, nk+1, rows] numpy operands: per batch row two runs of
    `rows` rows, a quarter of them pads, the leading key columns drawn
    from the bench keys' heads (BENCH_HEADS)."""
    rng = np.random.default_rng(seed)
    pad = rows // 4
    a = np.stack([_headed_operand(rng, rows - pad, nk, BENCH_HEADS,
                                  pad_rows=pad) for _ in range(batch)])
    b = np.stack([_headed_operand(rng, rows - pad, nk, BENCH_HEADS,
                                  pad_rows=pad, prio=1, idx_base=rows)
                  for _ in range(batch)])
    return a, b


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up (and build, on a first call)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def merge_bound(la: int, lb: int, n_cols: int, nk: int, skipped: float,
                col_bytes: int = 4) -> tuple:
    """(bound_ms, bound_by) for one merge on this run's inputs: the bytes
    it needs are the key columns a tile does not share read once (nk -
    skipped per tile on average, see skipped_key_columns: a column that
    one value fills throughout a tile is read only at its windows' ends),
    the payload columns read once and every output column written once,
    at col_bytes per value (4: the function's own u32 keys and int32
    index; 8: the port's int64 columns); against the operations of a
    sequential merge over the unshared columns (<= nk - skipped 32-bit
    compares per output, two for an int64 column) and the binary search
    of each 8-output diagonal."""
    total = la + lb
    keys = nk - skipped
    nbytes = (keys + (n_cols - nk) + n_cols) * col_bytes * total
    ops = (col_bytes // 4) * keys * total * (1 + max(1, total.bit_length()) / 8)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def merged_splits(a, b, nk: int):
    """The merge-path splits read off merge_two_sorted_plain's output: the
    number of A rows among its first min(t*TILE, la+lb) rows, t = 0..
    ceil((la+lb)/TILE). What merge_path_splits must equal."""
    import torch

    from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
    from pegasus_tpu_torch.ops.merge_path import TILE

    la, lb = a.shape[1], b.shape[1]
    side = [torch.zeros((1, la), dtype=torch.int64, device=a.device),
            torch.ones((1, lb), dtype=torch.int64, device=a.device)]
    merged = merge_two_sorted_plain(torch.cat([a, side[0]]),
                                    torch.cat([b, side[1]]), nk)
    from_a = torch.cat([torch.zeros(1, dtype=torch.int64, device=a.device),
                        torch.cumsum(merged[-1] == 0, dim=0)])
    d = torch.arange(-(-(la + lb) // TILE) + 1, device=a.device) * TILE
    return from_a[torch.clamp(d, max=la + lb)]


def skipped_key_columns(a, b, nk: int) -> float:
    """The mean number of leading key columns the tiled kernel skips per
    tile: those in which the first and last rows of both non-empty input
    windows agree (it reads them only at the windows' ends)."""
    import torch

    from pegasus_tpu_torch.ops.merge_path import (TILE,
                                                  merge_path_splits_plain)

    la, lb = a.shape[1], b.shape[1]
    if la + lb == 0:
        return 0.0
    splits = merge_path_splits_plain(a, b, nk)
    d = torch.clamp(torch.arange(splits.shape[0], device=a.device) * TILE,
                    max=la + lb)
    a0, b0 = splits[:-1], d[:-1] - splits[:-1]
    na, nb = splits[1:] - a0, d[1:] - splits[1:] - b0
    ends = []  # (first rows, last rows, window length) of each non-empty run
    for x, lo, n in ((a, a0, na), (b, b0, nb)):
        if x.shape[1]:
            ends.append((x[:nk, torch.clamp(lo, max=x.shape[1] - 1)],
                         x[:nk, torch.clamp(lo + n - 1, 0, x.shape[1] - 1)],
                         n))
    # the value every end must hold: A's first row where A's window is
    # non-empty, else B's
    ref = ends[0][0]
    if len(ends) == 2:
        ref = torch.where(na > 0, ends[0][0], ends[1][0])
    agree = torch.ones_like(ref, dtype=torch.bool)
    for first, last, n in ends:
        agree &= (n == 0) | ((first == ref) & (last == ref))
    return float(torch.cumprod(agree.long(), dim=0).sum(0).double().mean())


def _check_merge(ta, tb, nk: int, name: str) -> int:
    """Hold the merge kernel and the partition kernel against the plain
    versions on the same operands. -> max abs error."""
    import torch

    from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
    from pegasus_tpu_torch.ops.merge_path import (merge_path_splits,
                                                  merge_path_splits_plain,
                                                  merge_two_sorted)

    want = merge_two_sorted_plain(ta, tb, nk)
    got = merge_two_sorted(ta, tb, nk)
    splits = merge_path_splits(ta, tb, nk)
    plain_splits = merge_path_splits_plain(ta, tb, nk)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"merge kernel != plain merge: {name} "
                             f"(max abs err {err})")
    if not (torch.equal(splits, plain_splits) and torch.equal(
            splits, merged_splits(ta, tb, nk))):
        raise AssertionError(f"partition kernel != plain splits: {name}")
    return err


def check_kernel(device) -> dict:
    import torch

    max_err = 0
    cases = kernel_cases()
    for name, a, b, nk in cases:
        max_err = max(max_err, _check_merge(torch.from_numpy(a).to(device),
                                            torch.from_numpy(b).to(device),
                                            nk, name))
    # the bench-scale shape: two 4194304-row runs, nk=8 (7 lanes + kp), on
    # random lanes and on the bench keys' shared leading lanes
    la = lb = 4_194_304
    nk = 8
    rng = np.random.default_rng(1)
    ta = torch.from_numpy(_sorted_operand(rng, la - 1_000_000, nk,
                                          0, 1 << 31,
                                          pad_rows=1_000_000)).to(device)
    tb = torch.from_numpy(_sorted_operand(rng, lb - 1_000_000, nk, 0,
                                          1 << 31, pad_rows=1_000_000,
                                          prio=1, idx_base=la)).to(device)
    timed = {"large": _time_merge(ta, tb, nk)}
    ta = torch.from_numpy(_headed_operand(rng, la - 1_000_000, nk,
                                          BENCH_HEADS,
                                          pad_rows=1_000_000)).to(device)
    tb = torch.from_numpy(_headed_operand(rng, lb - 1_000_000, nk,
                                          BENCH_HEADS, pad_rows=1_000_000,
                                          prio=1, idx_base=la)).to(device)
    timed["large_shared_prefix"] = _time_merge(ta, tb, nk)
    # (a 4-run compaction's final merge is timed on its own operands in
    # the device_stage phase)
    return {"cases": len(cases) + 2, "max_abs_err": max_err, **timed}


def mixed_width_cases(seed: int = 12, threads: int = 8,
                      n: int = 60_000) -> list:
    """(name, a, b, nk) pairs of two key widths, nk 4 and 10 in turns
    (the geo phase's two tables), one pair per host thread."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(threads):
        nk = (4, 10)[t % 2]
        out.append((f"thread{t}_nk{nk}", _sorted_operand(rng, n, nk),
                    _sorted_operand(rng, n // 2, nk, prio=1, idx_base=n),
                    nk))
    return out


def check_mixed_widths(device, rounds: int = 8) -> dict:
    """Merges of different key widths launched from several host threads
    at once, each byte-equal to the plain merge: every launch asks the
    same shared-memory opt-in of the kernel, so no thread's launch fails
    on a limit another thread lowered."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
    from pegasus_tpu_torch.ops.merge_path import merge_two_sorted

    cases = [(name, torch.from_numpy(a).to(device),
              torch.from_numpy(b).to(device), nk)
             for name, a, b, nk in mixed_width_cases()]
    wants = [merge_two_sorted_plain(a, b, nk) for _, a, b, nk in cases]

    def one(i):
        name, a, b, nk = cases[i]
        for _ in range(rounds):
            got = merge_two_sorted(a, b, nk)
            torch.cuda.synchronize(device)
            if not torch.equal(got, wants[i]):
                raise AssertionError(f"mixed widths: {name} != plain")

    with ThreadPoolExecutor(len(cases)) as ex:
        list(ex.map(one, range(len(cases))))
    return {"threads": len(cases), "merges": len(cases) * rounds,
            "nk": sorted({c[3] for c in cases})}


def _time_merge(ta, tb, nk) -> dict:
    """Check one merge against the plain versions, then time the kernels
    (per merge call, partition pass included), the partition pass alone
    and the plain merge; bounds from the key columns this input's tiles
    skip."""
    from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
    from pegasus_tpu_torch.ops.merge_path import (merge_path_splits,
                                                  merge_two_sorted)

    la, lb = ta.shape[1], tb.shape[1]
    _check_merge(ta, tb, nk, f"{la}+{lb}")
    ms = _time_ms(lambda: merge_two_sorted(ta, tb, nk), 20)
    splits_ms = _time_ms(lambda: merge_path_splits(ta, tb, nk), 20)
    plain_ms = _time_ms(lambda: merge_two_sorted_plain(ta, tb, nk), 5)
    skipped = skipped_key_columns(ta, tb, nk)
    bound_ms, bound_by = merge_bound(la, lb, nk + 1, nk, skipped)
    return {"la": la, "lb": lb, "nk": nk, "ms": ms, "splits_ms": splits_ms,
            "skipped_key_columns": skipped,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_int64": merge_bound(la, lb, nk + 1, nk, skipped, 8)[0]}


def _check_batched(ta, tb, nk: int, name: str) -> int:
    """Hold the batched merge and partition kernels against the plain
    batched versions, and each batch row's splits against the plain
    merge's of that row alone. -> max abs error."""
    import torch

    from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
    from pegasus_tpu_torch.ops.merge_path import (merge_path_splits,
                                                  merge_path_splits_plain,
                                                  merge_two_sorted)

    want = merge_two_sorted_plain(ta, tb, nk)
    got = merge_two_sorted(ta, tb, nk)
    splits = merge_path_splits(ta, tb, nk)
    plain_splits = merge_path_splits_plain(ta, tb, nk)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"batched merge kernel != plain batched merge: "
                             f"{name} (max abs err {err})")
    if not torch.equal(splits, plain_splits) or not all(
            torch.equal(splits[r], merged_splits(ta[r], tb[r], nk))
            for r in range(ta.shape[0])):
        raise AssertionError(f"batched partition kernel != plain splits: "
                             f"{name}")
    return err


def _time_batched(ta, tb, nk: int) -> dict:
    """Check one batched merge against the plain versions, then time it
    (one call for the whole batch), the same rows as sequential 2-D calls,
    and the plain batched merge; the bound sums each row's own bound
    (merge_bound with that row's skipped key columns)."""
    from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
    from pegasus_tpu_torch.ops.merge_path import merge_two_sorted

    batch, n_cols, la = ta.shape
    lb = tb.shape[2]
    err = _check_batched(ta, tb, nk, f"B={batch} {la}+{lb}")
    ms = _time_ms(lambda: merge_two_sorted(ta, tb, nk), 20)
    seq_ms = _time_ms(lambda: [merge_two_sorted(ta[r], tb[r], nk)
                               for r in range(batch)], 10)
    plain_ms = _time_ms(lambda: merge_two_sorted_plain(ta, tb, nk), 3)
    skipped = [skipped_key_columns(ta[r], tb[r], nk) for r in range(batch)]
    bounds = [merge_bound(la, lb, n_cols, nk, k) for k in skipped]
    return {"batch": batch, "la": la, "lb": lb, "nk": nk, "ms": ms,
            "sequential_ms": seq_ms, "plain_ms": plain_ms,
            "skipped_key_columns": sum(skipped) / batch,
            "bound_ms": sum(b[0] for b in bounds), "bound_by": bounds[0][1],
            "bound_ms_int64": sum(merge_bound(la, lb, n_cols, nk, k, 8)[0]
                                  for k in skipped),
            "max_abs_err": err}


def check_batched_kernel(device) -> dict:
    """The batched cases (batched_kernel_cases), then the timed
    (32, 131072+131072, nk=8) merge on bench-shaped keys."""
    import torch

    max_err = 0
    cases = batched_kernel_cases()
    for name, a, b, nk in cases:
        max_err = max(max_err, _check_batched(
            torch.from_numpy(a).to(device), torch.from_numpy(b).to(device),
            nk, name))
    a, b = timed_batched_operands()
    timed = _time_batched(torch.from_numpy(a).to(device),
                          torch.from_numpy(b).to(device), 8)
    return {"cases": len(cases) + 1,
            "max_abs_err": max(max_err, timed["max_abs_err"]),
            "timed": timed}


# ------------------------------------------------------- fence lookup

def _key_run(keys, device):
    """A resident run (DeviceRun with its fence) of distinct stored keys,
    and the sorted key list."""
    from pegasus_tpu_torch.engine.block import KVBlock
    from pegasus_tpu_torch.ops.compact import pack_run_device
    from pegasus_tpu_torch.ops.device_lookup import build_fence_index

    keys = sorted(set(keys))
    n = len(keys)
    lens = np.fromiter(map(len, keys), np.int32, n)
    offs = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    # raw byte strings, not all of them stored keys: no partition hash
    dr = pack_run_device(KVBlock(
        np.frombuffer(b"".join(keys), np.uint8).copy(), offs, lens,
        np.full(n, ord("v"), np.uint8), np.arange(n, dtype=np.int64),
        np.ones(n, np.int32), np.zeros(n, np.uint32),
        np.zeros(n, np.uint32), np.zeros(n, np.bool_)), device=device)
    if dr.fence is None:
        build_fence_index(dr)
    return dr, keys


def lookup_edge_runs(device, seed: int = 4) -> list:
    """The fence lookup's edge cases as (name, DeviceRun, sorted keys):
    runs of 1 and 5 rows (a fence longer than the run, hi clamped to
    n - 1), keys with high-bit bytes (lanes above 0x7FFFFFFF, beside the
    0xFFFFFFFF pads), one-lane runs, one crowded hash key, random hash
    keys, a serve partition's keys in small (YCSB names under field0: the
    first lane takes a handful of values, so the fence narrows nothing)
    and one hash key over 40 000 rows (a window above 33 * 33 rows: three
    pivot rounds of the kernel's 32-lane groups and the last)."""
    from pegasus_tpu_torch.base.key_schema import generate_key

    rng = np.random.default_rng(seed)
    rows, lens = ycsb_hash_keys(np.arange(3000, dtype=np.int64))
    out = [("n1", [generate_key(b"h", b"s")]),
           ("n5", [generate_key(b"h%d" % i, b"s") for i in range(5)]),
           ("one_lane", [bytes([b]) for b in rng.integers(0, 256, 40)]),
           ("high_bit", [rng.integers(0, 256, int(rng.integers(1, 31)),
                                      dtype=np.uint8).tobytes()
                         for _ in range(3000)]),
           ("dense", [generate_key(b"onehash", b"%06d" % i)
                      for i in range(0, 18000, 3)]),
           ("random", [generate_key(b"hk%04d" % rng.integers(0, 3000),
                                    b"s%d" % rng.integers(0, 9))
                       for _ in range(2500)]),
           ("serve_lane0", [generate_key(rows[i, :lens[i]].tobytes(),
                                         SERVE_FIELD)
                            for i in range(len(lens))]),
           ("wide", [generate_key(b"widehash", b"%07d" % i)
                     for i in range(0, 80000, 2)])]
    return [(name,) + _key_run(keys, device) for name, keys in out]


# 4097: a multiple of no block's groups, ranges' or points'
LOOKUP_QUERY_COUNTS = (1, 127, 129, 300, 4097)


def lookup_queries(keys, rng, n: int = 300) -> list:
    """Point queries against a run's sorted keys: hits, a byte above a
    key, strict prefixes, keys past the lane window (the klen
    tie-break), high-bit bytes, the ends and empty."""
    pick = [keys[int(i)] for i in rng.integers(0, len(keys), n // 2)]
    q = list(pick)
    q += [k + b"\x00" for k in pick[:20]]
    q += [k[:-1] for k in pick[:20]]
    q += [k + b"X" * 40 for k in pick[:20]]
    q += [rng.integers(0, 256, int(rng.integers(1, 12)),
                       dtype=np.uint8).tobytes() for _ in range(n // 4)]
    q += [b"", b"\x00", b"\xff" * 50, keys[0], keys[-1]]
    return (q * (n // len(q) + 1))[:n]


def lookup_probe_cases(device, seed: int = 5) -> list:
    """(name, DeviceRun, packed point queries, packed range queries,
    point keys, ranges) over lookup_edge_runs at LOOKUP_QUERY_COUNTS
    queries (counts that fill no whole block of the kernel)."""
    from pegasus_tpu_torch.ops.device_lookup import pack_queries

    rng = np.random.default_rng(seed)
    rng_large = np.random.default_rng(seed + 1)
    out = []
    for name, dr, keys in lookup_edge_runs(device):
        q = lookup_queries(keys, rng)
        q_large = lookup_queries(keys, rng_large, max(LOOKUP_QUERY_COUNTS))
        for nq in LOOKUP_QUERY_COUNTS:
            pts = q[:nq] if nq <= len(q) else q_large[:nq]
            ranges = [(pts[i], pts[(i + 1) % nq]) for i in range(nq)]
            out.append((f"{name}/q{nq}", dr,
                        pack_queries([pts], dr.w, device),
                        pack_queries([[a for a, _ in ranges],
                                      [b for _, b in ranges]], dr.w, device),
                        pts, ranges))
    return out


def _check_fence(dr, packed, name: str, group: int = None,
                 want=None) -> int:
    """The kernel against the plain version on one probe: byte-equal,
    one launch counted. `group` launches the kernel with that many lanes
    per query (fence_lookup.launch_group) in place of the wrapper's
    choice; `want` is the plain version's answer, where the caller has
    it. -> 0 (the max abs difference)."""
    import torch

    from pegasus_tpu_torch.ops import fence_lookup as fl
    from pegasus_tpu_torch.ops.device_lookup import (fence_lookup,
                                                     fence_lookup_plain,
                                                     lookup_steps)

    before = fl.LAUNCHES["fence_lookup"]
    got = fence_lookup(dr, packed) if group is None else fl.launch_group(
        dr, packed, lookup_steps(dr), group)
    if fl.LAUNCHES["fence_lookup"] != before + 1:
        raise AssertionError(f"fence lookup {name}: no kernel launch")
    torch.cuda.synchronize()
    if want is None:
        want = fence_lookup_plain(dr, packed)
    if got.dtype != want.dtype or not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"fence lookup {name} (group {group}): kernel "
                             f"!= plain at {bad}")
    return 0


def fence_rounds(dr, packed):
    """The binary search's rounds per query on this data (the rounds in
    which its window is not empty), summed over the probe's sets: the
    plain version's loop with a count. -> int64 [q]."""
    import torch

    from pegasus_tpu_torch.ops.device_sort import lex_less

    w, n, step = dr.w, dr.n, dr.fence_step
    total = None
    for s in range(packed.shape[0]):
        qcols, qklen = packed[s, :w], packed[s, w]
        a = torch.searchsorted(dr.fence, qcols[0].contiguous(), side="left")
        b = torch.searchsorted(dr.fence, qcols[0].contiguous(), side="right")
        lo = torch.where(a > 0, ((a - 1) * step).clamp(max=n - 1), 0)
        hi = torch.where(b < dr.fence_len, (b * step).clamp(max=n - 1), n)
        length = (hi - lo).clamp(min=0)
        rounds = torch.zeros_like(length)
        while bool((length > 0).any()):
            half = length >> 1
            mid = lo + half
            midc = mid.clamp(max=dr.padded_len - 1)
            less = lex_less([dr.cols[j][midc] for j in range(w)]
                            + [dr.klen[midc]], list(qcols) + [qklen])
            active = length > 0
            rounds += active.to(rounds.dtype)
            lo = torch.where(active & less, mid + 1, lo)
            length = torch.where(active, torch.where(
                less, length - half - 1, half), 0)
        total = rounds if total is None else total + rounds
    return total


def fence_bound(dr, packed) -> dict:
    """The least time for one probe on this data: the bytes it must move
    (the packed queries and the fence read once, the w lanes and klen of
    every row its search probes, 8 B each, and the int32 answers written
    once) over the card's memory rate, against its operations (per round
    w + 1 64-bit compares, two 32-bit operations each, and the two fence
    searches) over the peak (the reference's search, whose probes the
    function needs at the least); and `chain_loads`, the chain of that
    search as a one-thread-per-query kernel runs it: the most dependent
    device-memory loads one query waits on in turn (one per round, plus
    the point lookup's equality load)."""
    n_sets, rows, nq = packed.shape
    rounds = fence_rounds(dr, packed)
    probes = int(rounds.sum())
    out_bytes = 4 * nq * (2 if n_sets == 2 else 1)
    nbytes = (packed.numel() * 8 + dr.fence_len * 8
              + probes * (dr.w + 1) * 8 + out_bytes
              + (nq * (dr.w + 1) * 8 if n_sets == 1 else 0))
    ops = probes * (dr.w + 1) * 2 + n_sets * nq * 2 * max(
        1, dr.fence_len.bit_length())
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "probes": probes,
            "chain_loads": int(rounds.max()) + (1 if n_sets == 1 else 0)}


FLUSH_BYTES = 256 << 20   # written before an L2-cold launch: 5x the L2


def fence_device_ms(call, cold: bool, reps: int = 30) -> float:
    """The fence kernel's own device time per launch (torch.profiler's
    device events of the kernels named fence_*, whatever launched them),
    over `reps` calls of `call`: back to back with the L2 warm, or with
    FLUSH_BYTES written just before each launch, so that the launch
    finds the run in device memory as a serving process's probe does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda") if cold else None
    call()
    torch.cuda.synchronize()
    # the trace loses a launch's record now and then (5 of 30 kept, once,
    # on the H100): the time is the mean over the records it holds, from
    # a trace that holds at least half of them
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                if flush is not None:
                    flush.fill_(i)
                call()
            torch.cuda.synchronize()
        ev = [(ms, c) for name, ms, c in _device_events(prof)
              if "fence_" in name]
        seen = sum(c for _, c in ev)
        if reps // 2 <= seen <= reps:
            return sum(ms for ms, _ in ev) / seen
    raise AssertionError(f"the profile holds {ev} fence kernels of {reps} "
                         f"launches")


def host_us(call, reps: int = 200) -> float:
    """Host microseconds per call of `call` (the wrapper: checks, output
    allocation, stream, launch), the kernels left to run behind."""
    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def probe_split(dr, points, ranges, reps: int = 20) -> dict:
    """One probe as device_lookup.lookup_batch / range_batch run it, its
    steps timed apart on the host clock (median microseconds over reps):
    pack_queries on the host, the upload, the launch (the wrapper's
    host time), the download (.cpu(), which waits for the kernel); and
    the whole lookup_batch / range_batch call."""
    import torch

    from pegasus_tpu_torch.ops.device_lookup import (fence_lookup,
                                                     lookup_batch,
                                                     pack_queries,
                                                     range_batch)

    dev = dr.cols.device
    out = {}
    for kind, sets, whole in (
            ("point", [points], lambda: lookup_batch(dr, points)),
            ("range", [[a for a, _ in ranges], [b for _, b in ranges]],
             lambda: range_batch(dr, ranges))):
        times = {k: [] for k in ("pack", "upload", "launch", "download",
                                 "whole")}
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = pack_queries(sets, dr.w, "cpu")
            t1 = time.perf_counter()
            packed = host.to(dev)
            t2 = time.perf_counter()
            got = fence_lookup(dr, packed)
            t3 = time.perf_counter()
            got.cpu().numpy()
            t4 = time.perf_counter()
            whole()
            t5 = time.perf_counter()
            if i:   # the first round warms the allocator
                for k, dt in (("pack", t1 - t0), ("upload", t2 - t1),
                              ("launch", t3 - t2), ("download", t4 - t3),
                              ("whole", t5 - t4)):
                    times[k].append(dt * 1e6)
        out[kind] = {k: float(np.median(v)) for k, v in times.items()}
    return out


def _rounds(rounds) -> dict:
    return {"max": int(rounds.max()), "mean": float(rounds.float().mean())}


def fence_probes(dr, keys, nq: int, seed: int = 9) -> dict:
    """One probe of nq point queries (half of them hits, half a byte
    above one) and one of nq ranges (consecutive sorted points) against
    `dr`: {kind: (queries, packed buffer on the run's device)}."""
    from pegasus_tpu_torch.ops.device_lookup import pack_queries

    rng = np.random.default_rng(seed)
    hits = [keys[int(i)] for i in rng.integers(0, len(keys), nq // 2)]
    pts = hits + [k + b"\x01" for k in hits][: nq - len(hits)]
    starts = sorted(pts)
    stops = starts[1:] + starts[:1]
    dev = dr.cols.device
    return {"point": (pts, pack_queries([pts], dr.w, dev)),
            "range": (list(zip(starts, stops)),
                      pack_queries([starts, stops], dr.w, dev))}


def time_fence(dr, keys, nq: int) -> dict:
    """The kernel and the plain version on fence_probes(nq), checked,
    then timed: `ms` the wrapper's calls back to back (CUDA events),
    `device_ms` and `device_ms_cold` the kernel alone, L2-warm and
    L2-cold (fence_device_ms), `host_us` the wrapper's host time per
    call, `plain_ms`; the bound; the binary search's rounds per query
    (`binary_rounds`, fence_rounds: a one-thread-per-query kernel's)
    and, where the tree has it, the kernel's (`rounds`,
    fence_lookup.search_model); and the probe's split (probe_split)."""
    from pegasus_tpu_torch.ops import fence_lookup as fl
    from pegasus_tpu_torch.ops.device_lookup import (fence_lookup,
                                                     fence_lookup_plain)

    out = {"rows": dr.n, "queries": nq, "w": dr.w,
           "fence_len": dr.fence_len}
    model = getattr(fl, "search_model", None)
    if model is not None:
        out["group"] = fl.group_for(nq)
    probes = fence_probes(dr, keys, nq)
    for kind, (_, packed) in probes.items():
        _check_fence(dr, packed, f"{dr.n} rows/{nq} {kind}")

        def call():
            return fence_lookup(dr, packed)

        rec = {"ms": _time_ms(call, 50),
               "device_ms": fence_device_ms(call, cold=False),
               "device_ms_cold": fence_device_ms(call, cold=True),
               "host_us": host_us(call),
               "plain_ms": _time_ms(lambda: fence_lookup_plain(dr, packed),
                                    3),
               **fence_bound(dr, packed),
               "binary_rounds": _rounds(fence_rounds(dr, packed))}
        if model is not None:
            rec["rounds"] = _rounds(model(dr, packed)[1])
        out[kind] = rec
    out["split_us"] = probe_split(dr, probes["point"][0],
                                  probes["range"][0])
    return out


def fence_group_sweep(dr, keys, counts=(64, 256, 1024, 4096)) -> dict:
    """The kernel at each of its lanes per query (fence_lookup.GROUPS) on
    fence_probes at each query count: checked, device ms L2-warm and
    L2-cold, rounds per query. -> {nq: {kind: {group: record}}}."""
    from pegasus_tpu_torch.ops import fence_lookup as fl
    from pegasus_tpu_torch.ops.device_lookup import lookup_steps

    out = {}
    for nq in counts:
        for kind, (_, packed) in fence_probes(dr, keys, nq).items():
            rec = out.setdefault(str(nq), {}).setdefault(kind, {})
            for g in fl.GROUPS:
                _check_fence(dr, packed, f"{dr.n} rows/{nq} {kind}", g)

                def call(g=g):
                    return fl.launch_group(dr, packed, lookup_steps(dr), g)

                rec[str(g)] = {
                    "device_ms": fence_device_ms(call, cold=False),
                    "device_ms_cold": fence_device_ms(call, cold=True),
                    "rounds": _rounds(fl.search_model(dr, packed, g)[1])}
    return out


def serve_partition_run(device, n: int = None):
    """A resident run shaped like one serve partition's (~312 K YCSB keys
    under sort key field0) and its sorted keys."""
    from pegasus_tpu_torch.base.key_schema import generate_key

    n = n or SERVE_RECORDS // SERVE_PARTITIONS
    rows, lens = ycsb_hash_keys(np.arange(n, dtype=np.int64))
    return _key_run([generate_key(rows[i, :lens[i]].tobytes(), SERVE_FIELD)
                     for i in range(n)], device)


def check_fence_kernel(device):
    """Every edge case, point and range, kernel byte-equal to the plain
    version on the card, at the wrapper's lanes per query and at each of
    the kernel's (fence_lookup.GROUPS); then the kernel timed on a serve
    partition's run at 64 and 4096 queries (time_fence). -> (the phase's
    record, that run and its keys)."""
    from pegasus_tpu_torch.ops.device_lookup import fence_lookup_plain
    from pegasus_tpu_torch.ops.fence_lookup import GROUPS

    cases = lookup_probe_cases(device)
    for name, dr, points, ranges, _, _ in cases:
        for kind, packed in (("point", points), ("range", ranges)):
            want = fence_lookup_plain(dr, packed)
            for group in (None,) + GROUPS:
                _check_fence(dr, packed, f"{name}/{kind}", group, want)
    n_cases = 2 * len(cases)
    del cases
    dr, keys = serve_partition_run(device)
    return {"cases": n_cases, "groups": [None, *GROUPS], "max_abs_err": 0,
            "serve_partition": {str(nq): time_fence(dr, keys, nq)
                                for nq in (64, 4096)}}, dr, keys


def _run_sample(blk, seed: int = 8) -> list:
    """8192 of a run's keys, sorted: the keys time_fence draws from."""
    rng = np.random.default_rng(seed)
    return sorted(blk.key(int(i)) for i in rng.integers(0, blk.n, 8192))


def fence_on_engine(eng, queries=(64, 4096)) -> dict:
    """The kernel on an engine's largest resident run (the reads phase's
    10 M-record compaction output), checked against the plain version
    and timed at each query count."""
    with eng._lock:
        ssts = list(eng._l0) + [f for fs in eng._levels.values() for f in fs]
    sst = max(ssts, key=lambda f: f.n)
    dr = eng._device_run_budgeted(sst)
    if dr is None or dr.fence is None:
        raise AssertionError("the engine's largest run is not resident")
    keys = _run_sample(sst.block())
    return {str(nq): time_fence(dr, keys, nq) for nq in queries}


def fence_measure(tree: str) -> dict:
    """`chip_smoke.py fence-measure TREE`: the fence kernel of the
    checkout at TREE (its pegasus_tpu_torch, imported ahead of this
    one's) on a serve partition's run and on a 10 M-record fill run
    (bench.py's first fill run at 10 M records, sorted: the shape of the
    reads phase's compaction output), time_fence at 64 and 4096 queries;
    in a tree with lanes per query to choose, fence_group_sweep.
    It uses only what every tree with the fence kernel has, so it times
    that tree's kernel and wrapper."""
    import torch

    sys.path.insert(0, tree)
    from pegasus_tpu_torch.ops import _build
    from pegasus_tpu_torch.ops import fence_lookup as fl
    from pegasus_tpu_torch.ops.compact import pack_run_device

    if not os.path.realpath(fl.__file__).startswith(os.path.realpath(tree)):
        raise AssertionError(f"imported {fl.__file__}, not {tree}'s")
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build("fence_lookup")
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    sweep = hasattr(fl, "GROUPS")
    dr, keys = serve_partition_run(device)
    out["serve_partition"] = {str(nq): time_fence(dr, keys, nq)
                              for nq in (64, 4096)}
    if sweep:
        out["serve_partition"]["by_group"] = fence_group_sweep(dr, keys)
    del dr
    blk = presort_run(make_run(N_RECORDS, 0, seed=0,
                               key_space=N_RECORDS // 2))
    dr = pack_run_device(blk, device=device)
    keys = _run_sample(blk)
    del blk
    out["fill_run"] = {str(nq): time_fence(dr, keys, nq)
                       for nq in (64, 4096)}
    if sweep:
        out["fill_run"]["by_group"] = fence_group_sweep(dr, keys)
    return out


def serve_measure(tree: str) -> dict:
    """`chip_smoke.py serve-measure TREE`: the serve phase (run_serve at
    its defaults) of the checkout at TREE, measured by that tree's own
    chip_smoke.py with its own package, both imported ahead of this
    one's (the client process it spawns inherits the path). -> the YCSB
    run's ops/s and get / set percentiles, the read-backs' keys/s and
    batch sizes."""
    import importlib

    import torch

    sys.path.insert(0, tree)
    sys.modules.pop("chip_smoke", None)
    cs = importlib.import_module("chip_smoke")
    if os.path.realpath(cs.__file__) != os.path.realpath(
            os.path.join(tree, "chip_smoke.py")):
        raise AssertionError(f"imported {cs.__file__}, not {tree}'s")
    cs._parallel_build(cs.BUILT)
    work = os.path.join(tree, ".scratch", "serve_measure")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        rep = cs.run_serve(torch.device("cuda"), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run = rep["run"]
    return {"tree": tree, "ops_per_s": run["ops_per_s"], "get": run["get"],
            "set": run["set"],
            "read_back_keys_per_s": [rep[k]["keys_per_s"] for k in (
                "read_back_after_run", "read_back_after_compaction")],
            "batch_size": rep["read_back_after_run"].get("batch_size")}


MEASURES = {"fence": "fence_measure", "serve": "serve_measure"}


def ab(phase: str, trees) -> list:
    """`chip_smoke.py <phase>-ab TREE [TREE ...]` (phase fence or serve):
    <phase>-measure of each tree in the order given (list a pair twice,
    reversed, to cancel the card's drift), each in a process of its own
    on the same card; one TREE means TREE and this checkout in turns
    (TREE, this, this, TREE). -> the records, each also emitted as a
    `<phase>_ab` line."""
    if len(trees) == 1:
        trees = [trees[0], ROOT, ROOT, trees[0]]
    out = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), f"{phase}-measure",
             os.path.abspath(tree)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{phase}-measure {tree} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.splitlines()[-1])
        emit(f"{phase}_ab", **rec)
        out.append(rec)
    return out


def _device_events(prof) -> list:
    """(name, device ms, calls) of a profile's device-side events
    (kernels, copies, sets), longest first. The operator-level events
    above them report the same device time again, so they are left out."""
    import torch

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    return sorted(((e.key, dev_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0),
                  key=lambda t: -t[1])


def profile_device_stage(runs, device) -> dict:
    """The compaction's device stage alone on the bench-scale runs, primed
    once: one warm-up pass, then one pass under torch.profiler. -> its
    wall ms, the device busy ms within it, device time by kernel, and the
    stage's own merges (kernel against plain merge on the operands the
    compaction gave them, both timed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.ops import compact
    from pegasus_tpu_torch.ops.compact import CudaBackend, pack_run_device

    drs = [pack_run_device(b, device=device) for b in runs]
    backend = CudaBackend(device)
    fargs = (NOW, 0, 0, True, True)
    operands = []
    kernel_merge = compact.merge_two_sorted

    def keep_operands(a, b, nk):
        # a single merge is the batch-of-one case: keep its [n_cols, L] row
        operands.append((a[0], b[0], nk))
        return kernel_merge(a, b, nk)

    compact.merge_two_sorted = keep_operands
    try:
        backend.survivors_cached_device(drs, *fargs)  # warm-up
    finally:
        compact.merge_two_sorted = kernel_merge
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
        else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        _, count = backend.survivors_cached_device(drs, *fargs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_events(prof)
    busy_ms = sum(k[1] for k in kernels)
    del drs
    merges = [_time_merge(a, b, nk) for a, b, nk in operands]
    del operands
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms), "survivors": count,
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": c}
                            for k, ms, c in kernels[:12]],
            "merges": merges}


# ---------------------------------------------------- engine main path

def cpu_digest(runs) -> tuple:
    """-> (digest, seconds) of the port's cpu-backend compaction of `runs`:
    what every device compaction of them is held to."""
    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks

    t0 = time.perf_counter()
    ref = compact_blocks(runs, CompactOptions(backend="cpu", now=NOW,
                                              bottommost=True,
                                              runs_sorted=True)).block
    return block_digest([ref]), time.perf_counter() - t0


def run_compaction(path: str, runs, device, want: dict,
                   device_values: bool = False) -> tuple:
    """Install `runs` (newest first) as L0 of a port engine on `device`,
    prime them, manual_compact(now=NOW) under a device-only profiler
    trace, and hold the output's digest to `want`. -> the engine and a
    report (the whole call's device busy time and idle share included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES

    eng = LsmEngine(path, EngineOptions(backend="cuda", device=device,
                                        l0_compaction_trigger=1 << 30,
                                        device_values=device_values))
    for blk in reversed(runs):  # the last installed is the newest
        eng.install_ingested_block(blk)
    t0 = time.perf_counter()
    primed = eng.prime_resident_runs()
    prime_s = time.perf_counter() - t0
    on_card = eng.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    launches_before = LAUNCHES["merge_path"]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        stats = eng.manual_compact(now=NOW)
        if on_card:
            torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
    launches = LAUNCHES["merge_path"] - launches_before
    events = _device_events(prof)
    busy_s = sum(e[1] for e in events) / 1e3
    merge_ms = sum(e[1] for e in events if "merge_path_" in e[0])
    got = block_digest(level_blocks(path, eng.opts.max_levels))
    if got != want:
        raise AssertionError(f"device compaction digest {got} != cpu "
                             f"backend digest {want}")
    return eng, {"records_in": stats["input_records"],
                 "records_out": stats["output_records"],
                 "primed_runs": primed, "prime_s": prime_s,
                 "compact_s": compact_s, "device_busy_s": busy_s,
                 "idle_share": max(0.0, 1 - busy_s / compact_s),
                 "merge_kernel_ms": merge_ms,
                 "top_device_events": [{"name": k[:90], "ms": ms, "calls": c}
                                       for k, ms, c in events[:6]],
                 "stages": stats["trace"], "merge_launches": launches,
                 "digest": got}


def run_reads(eng, runs, n_puts: int, n_gets: int, n_ranges: int,
              seed: int = 7) -> dict:
    """Writes + flush (device sort), then batched point and range reads
    held against the host walk."""
    from pegasus_tpu_torch.base.key_schema import generate_key, \
        generate_next_bytes
    from pegasus_tpu_torch.engine.db import WriteBatch
    from pegasus_tpu_torch.ops.fence_lookup import LAUNCHES as FENCE
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_puts)
    pairs = []
    decree = eng.last_committed_decree()
    for lo in range(0, n_puts, 1000):
        wb = WriteBatch()
        for i in ids[lo: lo + 1000]:
            wb.put(generate_key(b"newhash%09d" % i, b"s"),
                   b"\x82" + b"\x00" * 12 + b"w%d" % i)
        decree += 1
        pairs.append((wb, decree))
    t0 = time.perf_counter()
    eng.write_batch(pairs)
    eng.flush()
    write_s = time.perf_counter() - t0

    existing = [runs[i % len(runs)].key(int(j)) for i, j in enumerate(
        rng.integers(0, min(r.n for r in runs), size=n_gets // 2))]
    existing += [generate_key(b"newhash%09d" % i, b"s")
                 for i in rng.integers(0, n_puts, size=n_gets // 8)]
    misses = [generate_key(b"missing%09d" % i, b"s%d" % i)
              for i in range(n_gets - len(existing))]
    keys = existing + misses
    rng.shuffle(keys)
    FENCE["fence_lookup"] = 0
    with COMPACT_TRACER.session() as sess:
        t0 = time.perf_counter()
        got = eng.get_batch(keys, now=NOW)
        get_s = time.perf_counter() - t0
        hks = rng.integers(0, max(1, runs[0].n // 2), size=n_ranges)
        ranges = []
        for j in hks:
            k = runs[0].key(int(j))
            hk = k[2: 2 + 16]
            ranges.append((generate_key(hk), generate_next_bytes(hk)))
        ranges.append((ranges[0][0], None))  # an open stop
        t0 = time.perf_counter()
        scanned = [list(it) for it in eng.scan_range_batch(ranges[:-1],
                                                           now=NOW)]
        scan_s = time.perf_counter() - t0
        open_head = list(itertools.islice(
            eng.scan_range_batch(ranges[-1:], now=NOW)[0], 50))
    fence_launches = FENCE["fence_lookup"]
    stages = sess.summary()
    if stages.get("read.lookup", {}).get("calls", 0) == 0:
        raise AssertionError("get_batch ran no device lookup")
    if stages.get("read.range", {}).get("calls", 0) == 0:
        raise AssertionError("scan_range_batch ran no device range resolve")
    want = [eng.get(k, now=NOW) for k in keys]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"get_batch != host walk at key {keys[bad]!r}")
    for (s, t), rows in zip(ranges, scanned):
        if rows != list(eng.scan(s, t, now=NOW)):
            raise AssertionError(f"scan_range_batch != scan for {s!r}")
    if open_head != list(itertools.islice(
            eng.scan(ranges[-1][0], None, now=NOW), 50)):
        raise AssertionError("open-stop range != scan")
    hits = sum(v is not None for v in got)
    return {"puts": n_puts, "write_flush_s": write_s,
            "gets": len(keys), "get_hits": hits, "get_batch_s": get_s,
            "gets_per_s": len(keys) / get_s,
            "ranges": len(scanned), "range_rows": sum(map(len, scanned)),
            "scan_batch_s": scan_s, "ranges_per_s": len(scanned) / scan_s,
            "fence_launches": fence_launches,
            "device_stages": {k: stages[k] for k in ("read.lookup",
                                                     "read.range")}}


HEADROOM_RUNS = 16        # equal flushed runs of the headroom check
HEADROOM_ROWS = 20_000    # rows in each


def check_headroom(device, work: str, n_runs: int = HEADROOM_RUNS,
                   rows: int = HEADROOM_ROWS) -> dict:
    """Read residency's budget headroom on one cuda engine: n_runs equal
    flushed runs (each primed at the default budget, their bytes
    measured), the engine reopened with device_cache_bytes one byte above
    those bytes. Unpinned, its primes (prime_resident_runs) stop at 7/8
    of the budget, a run short; after set_read_residency(True) and
    wait_primes() every run is resident, the whole budget but a byte in
    use. Then get_batch over written keys and misses, equal to a cpu
    backend engine's given the same writes, through the fence-lookup
    kernel (its launches counted)."""
    import torch

    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine, \
        WriteBatch
    from pegasus_tpu_torch.ops.fence_lookup import LAUNCHES as FENCE
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    opts = dict(l0_compaction_trigger=1 << 30)
    paths = {b: os.path.join(work, b) for b in ("cuda", "cpu")}
    engs = {"cuda": LsmEngine(paths["cuda"],
                              EngineOptions(device=device, **opts)),
            "cpu": LsmEngine(paths["cpu"],
                             EngineOptions(backend="cpu", **opts))}
    rng = np.random.default_rng(21)
    ids = rng.permutation(n_runs * rows)
    for r in range(n_runs):
        wb = WriteBatch()
        for j in ids[r * rows: (r + 1) * rows]:
            wb.put(generate_key(b"headroom%08d" % j, b"s"),
                   b"\x82" + b"\x00" * 12 + b"h%d" % j)
        for e in engs.values():
            e.write_batch([(wb, r + 1)])
            e.flush()
    engs["cuda"].wait_primes()
    full = engs["cuda"].stats()
    if full["device_resident_ssts"] != n_runs:
        raise AssertionError(f"default budget: {full['device_resident_ssts']}"
                             f" of {n_runs} runs resident")
    total = full["device_resident_bytes"]
    engs["cuda"].close()
    budget = total + 1
    cap = budget - (budget >> 3)
    eng = LsmEngine(paths["cuda"], EngineOptions(
        device=device, device_cache_bytes=budget, **opts))
    try:
        t0 = time.perf_counter()
        eng.prime_resident_runs()
        cold = eng.stats()
        cold_s = time.perf_counter() - t0
        if not (cold["device_resident_ssts"] < n_runs
                and cap <= cold["device_resident_bytes"] < budget):
            raise AssertionError(f"unpinned primes past 7/8 of {budget}: "
                                 f"{cold['device_resident_ssts']} runs, "
                                 f"{cold['device_resident_bytes']} bytes")
        t0 = time.perf_counter()
        eng.set_read_residency(True)
        eng.wait_primes()
        hot = eng.stats()
        pin_s = time.perf_counter() - t0
        if not (hot["read_hot"] and hot["device_resident_ssts"] == n_runs
                and hot["device_resident_bytes"] == total):
            raise AssertionError(f"pinned: {hot['device_resident_ssts']} of "
                                 f"{n_runs} runs, "
                                 f"{hot['device_resident_bytes']} bytes")
        q = [generate_key(b"headroom%08d" % j, b"s")
             for j in rng.integers(0, n_runs * rows, size=4096)]
        q += [generate_key(b"headroom%08d" % (n_runs * rows + j), b"s")
              for j in range(512)]
        FENCE["fence_lookup"] = 0
        with COMPACT_TRACER.session() as sess:
            t0 = time.perf_counter()
            got = eng.get_batch(q, now=NOW)
            get_s = time.perf_counter() - t0
        launches = FENCE["fence_lookup"]
        lookups = sess.summary().get("read.lookup", {}).get("calls", 0)
        if got != engs["cpu"].get_batch(q, now=NOW):
            raise AssertionError("pinned get_batch != the cpu backend's")
        if lookups < n_runs:
            raise AssertionError(f"{lookups} device lookups over {n_runs} "
                                 f"pinned runs")
        if torch.device(device).type == "cuda" and launches == 0:
            raise AssertionError("the pinned reads launched no fence kernel")
    finally:
        eng.close()
        engs["cpu"].close()
    return {"runs": n_runs, "rows_per_run": rows, "budget_bytes": budget,
            "cap_bytes": cap,
            "unpinned": {"runs": cold["device_resident_ssts"],
                         "bytes": cold["device_resident_bytes"],
                         "seconds": cold_s},
            "pinned": {"runs": hot["device_resident_ssts"],
                       "bytes": hot["device_resident_bytes"],
                       "seconds": pin_s},
            "gets": len(q), "get_hits": sum(v is not None for v in got),
            "get_batch_s": get_s, "device_lookups": lookups,
            "fence_launches": launches}


# ------------------------------------------- L0 + cascade, deferred installs

LEVELS_RECORDS = 1_000_000   # the levels phase's fill (4 runs)
LEVELS_OPTS = dict(l0_compaction_trigger=1 << 30,
                   target_file_size_bytes=8 << 20, level_base_bytes=32 << 20,
                   level_size_ratio=4, max_levels=3)


def _levels_engine(path: str, backend: str, device, opts: dict):
    """An empty port engine with small level budgets; no L0 trigger
    fires on its own."""
    from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine

    return LsmEngine(path, EngineOptions(backend=backend, device=device,
                                         **opts))


def _install(eng, runs) -> None:
    for blk in reversed(runs):  # the last installed is the newest
        eng.install_ingested_block(blk)


def levels_digest(path: str) -> dict:
    """{"l0" | level: [file count, digest]} as the MANIFEST lists them."""
    from pegasus_tpu_torch.engine.sstable import read_sst

    with open(os.path.join(path, "MANIFEST")) as f:
        m = json.load(f)
    out = {"l0": [len(m["l0"]), block_digest(
        [read_sst(os.path.join(path, n))[0] for n in m["l0"]])]}
    for lv in sorted(m["levels"], key=int):
        out[lv] = [len(m["levels"][lv]), block_digest(
            level_blocks(path, int(lv)))]
    return out


def _hop_intervals(rec, name: str) -> list:
    return [(h["ts"], h["ts"] + h["duration_us"] / 1e6) for h in rec["hops"]
            if h["name"] == name]


def _levels_rounds(runs) -> list:
    """The fill's older half, then its newer half: the second round's L0
    merge meets L1 files it overlaps, and its cascade L2 files."""
    half = len(runs) // 2
    return [runs[half:], runs[:half]]


def run_levels(runs, device, work: str, opts: dict = LEVELS_OPTS) -> dict:
    """The engine's own L0 -> L1 compact() and its size-triggered cascade
    into L2 and L3 (`opts`) in two rounds (the fill's older two runs
    installed and compacted, then its newer two), on `device` at pipeline
    depths 1 (synchronous installs) and 2 (deferred installs: each
    output written on the install pool under the next merge), in turns
    1, 2, 2, 1 so the card's and the host's drift cancel. After each
    round every level's files are digest-equal to the cpu backend
    engine's after the same rounds. Per turn and round: compact()
    seconds, and settled seconds (compact() until every async prime it
    queued has landed: depth 2 hands the outputs' primes to the pool,
    depth 1 primes inline, so only the settled time is the same work at
    both), merges and kernel launches (counts set to 0 just before, read
    just after), sst_write seconds, and from the compaction's job trace
    the engine.merge and engine.install hop seconds and how long
    installs ran beside a merge. Per depth: the mean of its turns."""
    import torch

    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.runtime.job_trace import JOB_TRACER
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    rounds = _levels_rounds(runs)
    cpu = _levels_engine(os.path.join(work, "cpu"), "cpu", "cpu", opts)
    want, cpu_s = [], 0.0
    for rnd in rounds:
        _install(cpu, rnd)
        t0 = time.perf_counter()
        cpu.compact(now=NOW)
        cpu_s += time.perf_counter() - t0
        want.append(levels_digest(cpu.path))
    cpu.close()
    shutil.rmtree(os.path.join(work, "cpu"))
    out = {"records": sum(r.n for r in runs), "options": opts,
           "cpu_backend_s": cpu_s,
           "files": [{lv: v[0] for lv, v in w.items()} for w in want]}
    turns = {1: [], 2: []}
    depth_env = os.environ.get("PEGASUS_COMPACT_PIPELINE_DEPTH")
    try:
        for turn, depth in enumerate((1, 2, 2, 1)):
            os.environ["PEGASUS_COMPACT_PIPELINE_DEPTH"] = str(depth)
            path = os.path.join(work, f"turn{turn}")
            eng = _levels_engine(path, "cuda", device, opts)
            per_round = []
            for i, rnd in enumerate(rounds):
                _install(eng, rnd)
                eng.wait_primes()
                if on_card:
                    torch.cuda.synchronize(device)
                LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
                with COMPACT_TRACER.session() as sess, \
                        JOB_TRACER.job("compact", phase="levels",
                                       depth=depth, round=i) as jid:
                    t0 = time.perf_counter()
                    stats = eng.compact(now=NOW)
                    if on_card:
                        torch.cuda.synchronize(device)
                    compact_s = time.perf_counter() - t0
                    eng.wait_primes()
                    if on_card:
                        torch.cuda.synchronize(device)
                    settled_s = time.perf_counter() - t0
                launches = LAUNCHES["merge_path"]
                rec = JOB_TRACER.find(jid)
                merges = _hop_intervals(rec, "engine.merge")
                installs = _hop_intervals(rec, "engine.install")
                got = levels_digest(path)
                if got != want[i]:
                    raise AssertionError(f"levels depth {depth} round {i}: "
                                         f"{got} != cpu backend {want[i]}")
                if depth == 2 and not installs:
                    raise AssertionError("depth 2 deferred no install")
                per_round.append({
                    "compact_s": compact_s, "settled_s": settled_s,
                    "l0_records": stats["input_records"],
                    "merges": len(merges), "merge_launches": launches,
                    "merge_s": sum(e - s for s, e in merges),
                    "installs": len(installs),
                    "install_s": sum(e - s for s, e in installs),
                    "install_beside_merge_s": sum(
                        max(0.0, min(e, me) - max(s, ms))
                        for s, e in installs for ms, me in merges),
                    "stages": sess.summary()})
            eng.close()
            shutil.rmtree(path)
            if on_card and per_round[1]["merge_launches"] <= 3:
                raise AssertionError(f"levels depth {depth}: the second "
                                     f"round's cascade launched no merge "
                                     f"kernel: {per_round}")
            turns[depth].append({
                "compact_s": sum(r["compact_s"] for r in per_round),
                "settled_s": sum(r["settled_s"] for r in per_round),
                "merge_launches": sum(r["merge_launches"]
                                      for r in per_round),
                "sst_write_s": sum(r["stages"].get("sst_write", {})
                                   .get("s", 0.0) for r in per_round),
                "rounds": per_round})
    finally:
        if depth_env is None:
            os.environ.pop("PEGASUS_COMPACT_PIPELINE_DEPTH", None)
        else:
            os.environ["PEGASUS_COMPACT_PIPELINE_DEPTH"] = depth_env
    for depth, recs in turns.items():
        launches = {r["merge_launches"] for r in recs}
        if len(launches) != 1:
            raise AssertionError(f"levels depth {depth}: the turns launched "
                                 f"{launches} merges")
        out[f"depth{depth}"] = {
            **{k: sum(r[k] for r in recs) / len(recs)
               for k in ("compact_s", "settled_s", "sst_write_s")},
            "merge_launches": launches.pop(), "rounds": recs[0]["rounds"],
            "turns": recs}
    return out


# --------------------------------------- batched multi-partition path

N_CHILDREN = 32      # partitions after the split; child p takes over
                     # the runs of parent p % 16
DEFAULT_TTL = 86400
TTL_FROM_NOW = 3600


def partition_runs(runs, n_parts: int) -> list:
    """Each run cut into the partitions of an n_parts table (partition =
    hash32 & (n_parts - 1)). -> per partition its runs, newest first."""
    out = [[] for _ in range(n_parts)]
    for r in runs:
        part = r.hash32 & (n_parts - 1)
        for q in range(n_parts):
            out[q].append(r.gather(np.nonzero(part == q)[0]))
    return out


def split_jobs(runs, device, n_children: int = N_CHILDREN) -> list:
    """The compaction after a partition split (n_children / 2 ->
    n_children partitions): child p's job is its parent's runs, primed on
    `device` once per parent run and shared by the two siblings, with
    pidx p; about half of each child's rows belong to its sibling and
    must drop through partition_mask n_children - 1.
    -> [(runs, device_runs, pidx)]."""
    from pegasus_tpu_torch.ops.compact import pack_run_device

    n_parents = n_children // 2
    parents = partition_runs(runs, n_parents)
    primed = [[pack_run_device(b, device=device) for b in pr]
              for pr in parents]
    return [(parents[p % n_parents], primed[p % n_parents], p)
            for p in range(n_children)]


def tenth_prefix(blocks, sample: int = 100_000) -> bytes:
    """The hashkey prefix (of the bench keys' 16-byte hashkeys) whose
    share of a sample of the records is nearest a tenth, by ratio."""
    b = blocks[0]
    n = min(b.n, sample)
    keys = b.key_arena[: n * 26].reshape(n, 26)[:, 2:18]
    best, best_err = b"", np.inf
    for k in range(9, 17):
        pref, counts = np.unique(keys[:, :k], axis=0, return_counts=True)
        ratio = np.abs(np.log(counts / n / 0.1))  # 2x and 1/2x are as far
        i = int(np.argmin(ratio))
        err = float(ratio[i])
        if err < best_err:
            best, best_err = pref[i].tobytes(), err
    return best


def rule_ops(blocks) -> tuple:
    """A parsed user_specified_compaction spec for runs like `blocks`:
    delete the hashkeys with the prefix that holds about a tenth of them
    (tenth_prefix); give sort keys containing "A" a TTL of TTL_FROM_NOW
    from now."""
    from pegasus_tpu_torch.engine.compaction_rules import \
        parse_user_specified_compaction

    prefix = tenth_prefix(blocks).decode()
    spec = json.dumps({"ops": [
        {"type": "COT_DELETE", "params": "{}",
         "rules": [{"type": "FRT_HASHKEY_PATTERN", "params": json.dumps(
             {"pattern": prefix, "match_type": "SMT_MATCH_PREFIX"})}]},
        {"type": "COT_UPDATE_TTL", "params": json.dumps(
            {"type": "UTOT_FROM_NOW", "value": TTL_FROM_NOW}),
         "rules": [{"type": "FRT_SORTKEY_PATTERN", "params": json.dumps(
             {"pattern": "A", "match_type": "SMT_MATCH_ANYWHERE"})}]}]})
    ops = tuple(parse_user_specified_compaction(spec))
    if len(ops) != 2:
        raise AssertionError(f"user_specified_compaction spec parsed to "
                             f"{len(ops)} operations: {spec}")
    return ops


def split_post_opts(jobs) -> list:
    """Per child its own post-pass options: the first half carry the
    user_specified_compaction spec of rule_ops, the second half the table
    default_ttl."""
    from pegasus_tpu_torch.ops.compact import CompactOptions

    ops = rule_ops(jobs[0][0])
    half = len(jobs) // 2
    return [CompactOptions(now=NOW, user_ops=ops) if j < half
            else CompactOptions(now=NOW, default_ttl=DEFAULT_TTL)
            for j in range(len(jobs))]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_batched(jobs, post_opts, device) -> dict:
    """compact_partition_batch over the split's jobs: a warm-up call that
    keeps the merges' operands, then the counted call under torch.profiler
    (wall, stage spans, device busy and idle share, peak device memory,
    merge calls and rows); every partition's output digest held to the
    port's cpu backend on its job with the same options; then the same
    jobs one by one through compact_blocks(device_runs=...)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.ops import compact
    from pegasus_tpu_torch.ops.batched_compact import (_job_opts,
                                                       compact_partition_batch)
    from pegasus_tpu_torch.ops.compact import CompactOptions
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    pmask = len(jobs) - 1  # the children of a split into len(jobs)
    opts = CompactOptions(backend="cuda", device=device, now=NOW,
                          partition_mask=pmask, bottommost=True,
                          runs_sorted=True)
    operands = []
    kernel_merge = compact.merge_two_sorted

    def keep_operands(a, b, nk):
        operands.append((a, b, nk))
        return kernel_merge(a, b, nk)

    compact.merge_two_sorted = keep_operands
    try:
        compact_partition_batch(jobs, opts, post_opts=post_opts)  # warm-up
    finally:
        compact.merge_two_sorted = kernel_merge
    _sync(device)
    base = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
    with COMPACT_TRACER.session() as sess, \
            profile(activities=activities) as prof:
        t0 = time.perf_counter()
        outs = compact_partition_batch(jobs, opts, post_opts=post_opts)
        _sync(device)
        wall_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device) - base) if on_card \
        else None
    events = _device_events(prof)
    busy_s = sum(e[1] for e in events) / 1e3
    t0 = time.perf_counter()

    def check(item):
        (runs, _, pidx), got, po = item
        want = compact.compact_blocks(runs, CompactOptions(
            backend="cpu", now=NOW, pidx=pidx,
            partition_mask=pmask, bottommost=True,
            runs_sorted=True, user_ops=po.user_ops,
            default_ttl=po.default_ttl)).block
        if block_digest([got]) != block_digest([want]):
            raise AssertionError(f"batched partition {pidx}: digest "
                                 f"{block_digest([got])} != cpu backend "
                                 f"{block_digest([want])}")

    _parallel(check, list(zip(jobs, outs, post_opts)))
    cpu_s = time.perf_counter() - t0
    LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
    t0 = time.perf_counter()
    one_by_one = [compact.compact_blocks(
        runs, _job_opts(opts, post_opts, j, pidx, NOW),
        device_runs=drs).block for j, (runs, drs, pidx) in enumerate(jobs)]
    _sync(device)
    seq_s = time.perf_counter() - t0
    seq_launches = dict(LAUNCHES)
    for got, seq in zip(outs, one_by_one):
        if block_digest([got]) != block_digest([seq]):
            raise AssertionError("one-by-one compact_blocks != batched")
    return {"partitions": len(jobs), "runs_per_partition": len(jobs[0][0]),
            "padded_rows": sum(sum(d.padded_len for d in drs)
                               for _, drs, _ in jobs),
            "records_in": sum(sum(b.n for b in r) for r, _, _ in jobs),
            "records_out": sum(b.n for b in outs),
            "wall_s": wall_s, "stages": sess.summary(),
            "device_busy_s": busy_s,
            "idle_share": max(0.0, 1 - busy_s / wall_s),
            "top_device_events": [{"name": k[:90], "ms": ms, "calls": c}
                                  for k, ms, c in events[:6]],
            "peak_device_bytes": peak,
            "merge_calls": launches["merge_path"],
            "merge_rows": launches["merge_path_rows"],
            "cpu_check_s": cpu_s,
            "one_by_one_s": seq_s,
            "one_by_one_merge_calls": seq_launches["merge_path"],
            "digests_equal": True, "operands": operands}


def run_blockwise(runs, device, want: dict, budget: int) -> dict:
    """compact_blocks(backend="cuda", max_device_records=budget) over the
    bench runs at PEGASUS_COMPACT_PIPELINE_DEPTH 1 and 2, each digest held
    to the cpu backend's `want`: ranges (the device stage's calls), stage
    spans, the pipeline's stall and overlap seconds, wall time, merge
    calls and the peak device memory above what was allocated before."""
    import gc

    import torch

    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    opts = CompactOptions(backend="cuda", device=device, now=NOW,
                          bottommost=True, runs_sorted=True,
                          max_device_records=budget)
    env = "PEGASUS_COMPACT_PIPELINE_DEPTH"
    saved = os.environ.get(env)
    out = {"budget": budget, "records_in": sum(r.n for r in runs)}
    try:
        for depth in (1, 2):
            os.environ[env] = str(depth)
            gc.collect()
            base = 0
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
            with COMPACT_TRACER.session() as sess:
                t0 = time.perf_counter()
                res = compact_blocks(runs, opts)
                _sync(device)
                wall_s = time.perf_counter() - t0
            launches = LAUNCHES["merge_path"]
            got = block_digest([res.block])
            if got != want:
                raise AssertionError(f"blockwise depth {depth}: digest {got} "
                                     f"!= cpu backend digest {want}")
            stages = sess.summary()
            ranges = stages["device"]["calls"]
            out[f"depth{depth}"] = {
                "wall_s": wall_s, "ranges": ranges,
                "padded_rows_per_range": stages["device"]["records"] / ranges,
                "merge_calls": launches,
                "stall_s": stages.get("pipeline.stall", {}).get("s", 0.0),
                "overlap_s": stages.get("pipeline.overlap", {}).get("s",
                                                                    0.0),
                "stages": stages,
                "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                      - base) if on_card else None,
                "records_out": res.block.n, "digest": got}
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved
    return out


# ------------------------------------------------ compaction offload

OFFLOAD_PARTS = 16   # every round ships one partition of a 16-way split
                     # of the fill (the whole fill until the clock cut)
OFFLOAD_JOB_PART = 2  # the partition of the first job and its local merge


def _offload_ini(work: str, device) -> str:
    """The [apps.offload] section of a compaction offload service on the
    card (`device = cpu` only when rehearsed on the CPU)."""
    import torch

    dev = "" if torch.device(device).type == "cuda" else \
        f"device = {device}\n"
    return (f"[apps.offload]\ntype = compact_offload\nbackend = cuda\n"
            f"port = 0\njob_dir = {os.path.join(work, 'offload')}\n{dev}")


def _round(runs, opts, addr: str, tenant: str) -> dict:
    """One offload round. -> {result, wall_s, the service's
    load/merge/publish seconds, bytes and runs shipped, bytes fetched}."""
    from pegasus_tpu_torch.replication.compact_offload import \
        offload_compact_blocks

    t0 = time.perf_counter()
    res = offload_compact_blocks(runs, opts, addr, tenant=tenant)
    wall_s = time.perf_counter() - t0
    st = res.stats
    return {"result": res, "wall_s": wall_s,
            "service_s": {sp["name"].rsplit(".", 1)[-1] + "_s":
                          sp["duration_us"] / 1e6
                          for sp in st["service_spans"]
                          if sp["name"] in ("offload.svc.load",
                                            "offload.svc.merge",
                                            "offload.svc.publish")},
            "shipped_bytes": st["shipped_bytes"],
            "fetched_bytes": st["fetched_bytes"],
            "shipped_runs": st["shipped_runs"],
            "skipped_runs": st["skipped_runs"],
            "records_in": st["input_records"],
            "records_out": res.block.n}


def _spans(sess, rnd: dict) -> dict:
    """The offload.ship/merge/fetch seconds of a trace session that saw
    one round, and the wire's MB/s through ship and fetch."""
    stages = sess.summary()
    spans = {k: stages[k]["s"] for k in ("offload.ship", "offload.merge",
                                         "offload.fetch")}
    return {"spans_s": spans,
            "ship_mb_s": (rnd["shipped_bytes"] / 1e6 / spans["offload.ship"]
                          if rnd["shipped_bytes"] else None),
            "fetch_mb_s": rnd["fetched_bytes"] / 1e6
            / spans["offload.fetch"]}


def run_offload(runs, device, work: str) -> dict:
    """The compaction offload service in-process (CompactOffloadApp from
    an ini: backend = cuda, max_concurrent 2, root under `work`), its
    tenants the port's client in this process, each round one partition
    of a 16-way split of `runs`:

      1. partition OFFLOAD_JOB_PART's job (the cpu_digest options): digest
         equal to its cpu merge, offloaded, one merge done; its
         merge-kernel launches counted on the service; under
         torch.profiler for the device's busy time over the service's
         merge, and the peak device memory;
      2. two tenants at once, partitions 0 and 1, one with a default_ttl,
         one with user rules: each digest equal to its own cpu merge,
         neither refused;
      3. the first tenant's job again: nothing shipped, the same digest;

    plus round 1's runs through compact_blocks(backend="cuda") locally,
    for the wire's share."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.runtime.config import Config
    from pegasus_tpu_torch.runtime.service_app import CompactOffloadApp
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    split = partition_runs(runs, OFFLOAD_PARTS)
    job_runs = split[OFFLOAD_JOB_PART]
    want, _ = cpu_digest(job_runs)
    app = CompactOffloadApp("offload", Config(text=_offload_ini(work, device)),
                            "apps.offload").start()
    out = {"job_partition": f"{OFFLOAD_JOB_PART} of {OFFLOAD_PARTS}",
           "job_records": sum(r.n for r in job_runs),
           "reduced": {"job": "the 10 M-record fill -> one partition of its "
                       "16-way split: the wire's share of a round (85-87 %"
                       ") has stood since the whole fill's rounds"}}
    try:
        status = app.svc.status()
        if status["backend"] != "cuda" or status["max_concurrent"] != 2:
            raise AssertionError(f"offload service status {status}")
        opts = CompactOptions(backend="cpu", now=NOW, bottommost=True,
                              runs_sorted=True)
        base = 0
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if on_card else [])
        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        with COMPACT_TRACER.session() as sess, \
                profile(activities=activities) as prof:
            first = _round(job_runs, opts, app.address, "bench")
        launches = LAUNCHES["merge_path"]
        first.update(_spans(sess, first))
        events = _device_events(prof)
        busy_s = sum(e[1] for e in events) / 1e3
        merge_s = first["service_s"]["merge_s"]
        res = first.pop("result")
        got = block_digest([res.block])
        if got != want or not res.stats["offloaded"]:
            raise AssertionError(f"offloaded job digest {got} != cpu backend "
                                 f"digest {want}")
        if app.svc.status()["merges_done"] != 1:
            raise AssertionError(f"service status {app.svc.status()}")
        out["job"] = dict(
            first, merge_launches=launches, device_busy_s=busy_s,
            idle_share_over_merge=(max(0.0, 1 - busy_s / merge_s)
                                   if busy_s else None),
            top_device_events=[{"name": k[:90], "ms": ms, "calls": c}
                               for k, ms, c in events[:6]],
            peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                               - base) if on_card else None,
            digest=got)
        del res

        local_opts = CompactOptions(backend="cuda", device=device, now=NOW,
                                    bottommost=True, runs_sorted=True)
        t0 = time.perf_counter()
        local = compact_blocks(job_runs, local_opts)
        _sync(device)
        out["local_s"] = time.perf_counter() - t0
        if block_digest([local.block]) != want:
            raise AssertionError("local cuda compaction digest != cpu backend")
        del local

        parts = split[:2]
        tenants = [CompactOptions(backend="cpu", now=NOW, bottommost=True,
                                  runs_sorted=True, default_ttl=DEFAULT_TTL),
                   CompactOptions(backend="cpu", now=NOW, bottommost=True,
                                  runs_sorted=True,
                                  user_ops=rule_ops(parts[1]))]
        rounds, errors = [None, None], []

        def tenant(i):
            try:
                rounds[i] = _round(parts[i], tenants[i], app.address,
                                   f"tenant{i}")
            except Exception as e:  # raised below
                errors.append(e)

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in (0, 1)]
        with COMPACT_TRACER.session() as sess:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            both_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent tenants failed: {errors}")
        for i, (prt, o) in enumerate(zip(parts, tenants)):
            ref = compact_blocks(prt, o).block
            if block_digest([rounds[i].pop("result").block]) != \
                    block_digest([ref]):
                raise AssertionError(f"tenant {i}: offloaded digest != its "
                                     f"cpu merge")
        # the session saw both rounds: their spans overlap, so the wire's
        # rate is both rounds' bytes over the wall time
        nbytes = sum(r["shipped_bytes"] + r["fetched_bytes"] for r in rounds)
        out["two_tenants"] = {"wall_s": both_s, "rounds": rounds,
                              "spans_s_both": {
                                  k: v["s"] for k, v in sess.summary().items()
                                  if k.startswith("offload.")},
                              "wire_mb_s_over_wall": nbytes / 1e6 / both_s}

        # tenant 0's job again: every run already staged, nothing shipped
        with COMPACT_TRACER.session() as sess:
            again = _round(parts[0], tenants[0], app.address, "tenant0")
        again.update(_spans(sess, again))
        res = again.pop("result")
        if (again["shipped_bytes"] != 0
                or again["skipped_runs"] != len(parts[0])
                or block_digest([res.block]) != block_digest(
                    [compact_blocks(parts[0], tenants[0]).block])):
            raise AssertionError(f"repeated job shipped "
                                 f"{again['shipped_bytes']} bytes, skipped "
                                 f"{again['skipped_runs']} runs")
        out["again"] = again
        del res
        out["status"] = app.svc.status()
    finally:
        app.stop()
    return out


def _remote_command(addr: str, command: str, args=(),
                    timeout: float = 30) -> str:
    from pegasus_tpu_torch.rpc import codec
    from pegasus_tpu_torch.rpc.transport import RpcConnection
    from pegasus_tpu_torch.runtime.remote_command import (
        RemoteCommandRequest, RemoteCommandResponse)

    host, _, port = addr.rpartition(":")
    conn = RpcConnection((host, int(port)))
    try:
        _, body = conn.call("RPC_CLI_CLI_CALL", codec.encode(
            RemoteCommandRequest(command, list(args))), timeout=timeout)
    finally:
        conn.close()
    return codec.decode(RemoteCommandResponse, body).output


def run_server(runs, device, work: str) -> dict:
    """`python -m pegasus_tpu_torch.server --config <ini> --app offload` as
    a subprocess (backend = cuda, port 0): wait for its started line,
    read offload-status (backend cuda, 2 free slots), run one partition
    of a 16-way split through it (digest equal to its cpu merge), stop it
    with SIGTERM. -> boot, round and stop seconds."""
    import signal

    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    os.makedirs(work, exist_ok=True)
    ini = os.path.join(work, "server.ini")
    with open(ini, "w") as f:
        f.write(_offload_ini(work, device))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pegasus_tpu_torch.server", "--config", ini,
         "--app", "offload"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=work,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        line = ""
        while "started" not in line:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode}: "
                                     f"{proc.stderr.read()[-2000:]}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("server did not start in 300 s")
        boot_s = time.perf_counter() - t0
        addr = line.split()[-1]
        status = json.loads(_remote_command(addr, "offload-status"))
        if status["backend"] != "cuda" or status["free_slots"] != 2:
            raise AssertionError(f"server offload-status {status}")
        part = partition_runs(runs, OFFLOAD_PARTS)[OFFLOAD_JOB_PART]
        opts = CompactOptions(backend="cpu", now=NOW, bottommost=True,
                              runs_sorted=True)
        with COMPACT_TRACER.session() as sess:
            rnd = _round(part, opts, addr, "server")
        rnd.update(_spans(sess, rnd))
        if block_digest([rnd.pop("result").block]) != \
                block_digest([compact_blocks(part, opts).block]):
            raise AssertionError("server round digest != its cpu merge")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        stop_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"server exited {rc} on SIGTERM: "
                                 f"{proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"boot_s": boot_s, "status": status, "round": rnd,
            "stop_s": stop_s, "rc": rc}


# ------------------------------------------- the partition data plane

# BASELINE config #3: YCSB workload-A (50/50 read/update), 32 hash
# partitions. One replica per partition; records of YCSB's core workload
# (insertorder=hashed key names, fieldlength=100) cut from 10 fields to 1
# as tools/ycsb_bench.py does.
SERVE_PARTITIONS = 32
SERVE_RECORDS = 10_000_000
SERVE_FILES = 4            # raw-set files per partition
SERVE_OPS = 25_000         # 200 000 until the cluster phase took on the
                           # table lifecycle, 100 000 until the doctor and
                           # scheduler legs, 50 000 until geo and the heal
                           # leg: cut for the clock
SERVE_THREADS = 8
SERVE_SAMPLE = 50_000      # untouched keys read back (100 000 until the
                           # levels phase and the cluster's lock-order
                           # and tracing costs needed the clock)
SERVE_THETA = 0.99
SERVE_APP_ID = 3
SERVE_FIELD = b"field0"
SERVE_TIMEOUT_S = 900.0    # one partition's ingest RPC
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 1099511628211


def ycsb_hash_keys(ranks: np.ndarray) -> tuple:
    """YCSB's hashed key names, "user" + the decimal of fnvhash64(rank)
    (CoreWorkload.buildKeyName with insertorder=hashed). -> ([n, 23]
    uint8 rows, int32 lengths): row i's first lengths[i] bytes."""
    h = np.full(len(ranks), _FNV_OFFSET, np.uint64)
    v = ranks.astype(np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            h *= np.uint64(_FNV_PRIME)
            v >>= np.uint64(8)
    # Java's Math.abs of the signed 64-bit value
    mag = h.view(np.int64)
    neg = mag < 0
    h = np.where(neg, (~h) + np.uint64(1), h)
    digits = np.zeros((len(ranks), 19), np.uint8)
    ndig = np.ones(len(ranks), np.int32)
    x = h.copy()
    for j in range(19):
        digits[:, 18 - j] = (x % np.uint64(10)).astype(np.uint8) + 48
        x //= np.uint64(10)
        ndig = np.where(x > 0, j + 2, ndig)
    rows = np.zeros((len(ranks), 23), np.uint8)
    rows[:, :4] = np.frombuffer(b"user", np.uint8)
    # left-align the significant digits after "user"
    col = np.arange(19)[None, :]
    src = 19 - ndig[:, None] + col
    ok = col < ndig[:, None]
    rows[:, 4:][ok] = digits[np.nonzero(ok)[0], src[ok]]
    return rows, (4 + ndig).astype(np.int32)


def hash_key(rank: int) -> bytes:
    """ycsb_hash_keys for one rank, in plain integers (the client path)."""
    h, v = _FNV_OFFSET, rank
    for _ in range(8):
        h = ((h ^ (v & 0xFF)) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
        v >>= 8
    return b"user%d" % (h if h < 1 << 63 else (1 << 64) - h)


_FILLER = np.random.default_rng(12345).integers(
    65, 91, 80, dtype=np.uint8).tobytes()


def loaded_value(rank: int) -> bytes:
    """The 100-byte value a record is bulk-loaded with."""
    return b"L%019d" % rank + _FILLER


def loaded_values(ranks: np.ndarray) -> np.ndarray:
    """[n, 100] uint8 rows of loaded_value(rank) for many ranks."""
    out = np.empty((len(ranks), 100), np.uint8)
    out[:, 0] = ord("L")
    x = ranks.astype(np.int64).copy()
    for j in range(19):
        out[:, 19 - j] = (x % 10 + 48).astype(np.uint8)
        x //= 10
    out[:, 20:] = np.frombuffer(_FILLER, np.uint8)
    return out


def update_value(tid: int, seq: int) -> bytes:
    return b"U%02d%017d" % (tid, seq) + _FILLER


class ZipfRanks:
    """YCSB's quick-zipfian rank generator over [0, n): P(rank k) ~
    1/(k+1)^theta (bench.py's ZipfKeys formula, copied)."""

    def __init__(self, n: int, theta: float = SERVE_THETA):
        self.n = n
        self.zetan = float(np.sum(1.0 / np.arange(1, n + 1,
                                                  dtype=np.float64) ** theta))
        self.zeta2 = 1.0 + 0.5 ** theta
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = ((1.0 - (2.0 / n) ** (1.0 - theta))
                    / (1.0 - self.zeta2 / self.zetan))

    def pick(self, rng) -> int:
        u = rng.random()
        uz = u * self.zetan
        if uz < 1.0:
            return 0
        if uz < self.zeta2:
            return 1
        return min(self.n - 1,
                   int(self.n * (self.eta * u - self.eta + 1.0)
                       ** self.alpha))


def _partition_of(hk_rows, hk_lens, n_parts: int) -> np.ndarray:
    from pegasus_tpu_torch.base.crc64 import crc64_batch

    n = len(hk_lens)
    h = crc64_batch(hk_rows.reshape(-1),
                    np.arange(n, dtype=np.int64) * hk_rows.shape[1],
                    hk_lens.astype(np.int64))
    return (h % np.uint64(n_parts)).astype(np.int64)


def write_provider(root: str, app: str, n_records: int, n_parts: int,
                   n_files: int, seed: int = 21) -> list:
    """The bulk-load provider tree: every record's hash key routed to its
    partition (key_hash % n_parts), each partition's rows shuffled (raw
    sets are unsorted) and cut into n_files raw-set files. -> records per
    partition."""
    from pegasus_tpu_torch.engine.bulk_load import (write_metadata,
                                                    write_raw_columns)

    rng = np.random.default_rng(seed)
    counts = [0] * n_parts
    rows = np.empty((n_records, 23), np.uint8)
    lens = np.empty(n_records, np.int32)
    chunk = 1 << 21
    for lo in range(0, n_records, chunk):
        hi = min(n_records, lo + chunk)
        rows[lo:hi], lens[lo:hi] = ycsb_hash_keys(
            np.arange(lo, hi, dtype=np.int64))
    part = _partition_of(rows, lens, n_parts)
    order = np.argsort(part, kind="stable")
    bounds = np.searchsorted(part[order], np.arange(n_parts + 1))
    for p in range(n_parts):
        ranks = rng.permutation(order[bounds[p]: bounds[p + 1]])
        counts[p] = len(ranks)
        pdir = os.path.join(root, app, str(n_parts), str(p))
        os.makedirs(pdir, exist_ok=True)
        for f, fr in enumerate(np.array_split(ranks, n_files)):
            n = len(fr)
            fl = lens[fr]
            ok = np.arange(rows.shape[1])[None, :] < fl[:, None]
            hk_off = np.zeros(n, np.int64)
            np.cumsum(fl[:-1], out=hk_off[1:])
            sk = np.frombuffer(SERVE_FIELD * n, np.uint8)
            write_raw_columns(
                os.path.join(pdir, f"{f:02d}.raw"),
                (rows[fr][ok], hk_off, fl),
                (sk, np.arange(n, dtype=np.int64) * len(SERVE_FIELD),
                 np.full(n, len(SERVE_FIELD), np.int32)),
                (loaded_values(fr).reshape(-1),
                 np.arange(n, dtype=np.int64) * 100,
                 np.full(n, 100, np.int32)),
                np.zeros(n, np.uint32))
    write_metadata(root, app, n_parts)
    return counts


def _parallel(fn, items) -> list:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        return list(ex.map(fn, items))


_INGEST_WANT = {}   # (provider, app, n_parts, pidx, prefix, version) -> digest


def ingest_want(provider: str, app: str, n_parts: int, pidx: int,
                prefix_u32: int, data_version: int) -> dict:
    """The cpu backend's compaction of partition pidx's raw sets with the
    ingest's filter (rows that do not hash to the partition dropped,
    partition_mask n_parts - 1, now 0), as a digest; computed once per
    partition and kept for every phase that ingests the same provider."""
    from pegasus_tpu_torch.base.value_schema import SCHEMAS
    from pegasus_tpu_torch.engine.bulk_load import load_ingest_file
    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks

    key = (provider, app, n_parts, pidx, prefix_u32, data_version)
    if key not in _INGEST_WANT:
        pdir = os.path.join(provider, app, str(n_parts), str(pidx))
        schema = SCHEMAS[data_version]
        raw = [load_ingest_file(os.path.join(pdir, n), schema)
               for n in sorted(os.listdir(pdir))]
        _INGEST_WANT[key] = block_digest([compact_blocks(raw, CompactOptions(
            backend="cpu", prefix_u32=prefix_u32, filter=True, pidx=pidx,
            partition_mask=n_parts - 1, bottommost=False, runs_sorted=False,
            now=0)).block])
    return _INGEST_WANT[key]


def check_ingest(servers, provider: str, app: str, n_parts: int) -> float:
    """Hold every partition's installed ingest run to the cpu backend's
    compaction of the same raw sets (ingest_want). -> seconds."""
    def one(srv):
        eng = srv.engine
        want = ingest_want(provider, app, n_parts, srv.pidx,
                           eng.opts.prefix_u32, eng.data_version())
        got = block_digest(engine_blocks(eng.path))
        if got != want:
            raise AssertionError(f"partition {srv.pidx}: ingested run {got}"
                                 f" != cpu backend {want}")

    t0 = time.perf_counter()
    _parallel(one, servers)
    return time.perf_counter() - t0


def keep_runs(servers, snap: str) -> list:
    """Flush every engine and hard-link its SSTs (newest first) under
    `snap`, so they outlive the compaction that deletes them. -> one
    [file, ...] per server, in order."""
    kept = []
    for i, srv in enumerate(servers):
        srv.engine.flush()
        d = os.path.join(snap, str(i))
        os.makedirs(d)
        kept.append([])
        for f in engine_files(srv.engine.path):
            os.link(f, os.path.join(d, os.path.basename(f)))
            kept[-1].append(os.path.join(d, os.path.basename(f)))
    return kept


def check_compaction(servers, kept: list) -> float:
    """Hold every engine's manual-compaction output to the cpu backend's
    compaction of its kept pre-compaction runs with the engine's own
    options. -> seconds."""
    from pegasus_tpu_torch.engine.sstable import read_sst
    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks

    def one(i):
        srv = servers[i]
        o = srv.engine.opts
        runs = [read_sst(f)[0] for f in kept[i]]
        want = block_digest([compact_blocks(runs, CompactOptions(
            backend="cpu", prefix_u32=o.prefix_u32, pidx=o.pidx,
            partition_mask=o.partition_mask, bottommost=True,
            default_ttl=o.default_ttl, runs_sorted=True,
            user_ops=tuple(o.user_ops))).block])
        got = block_digest(engine_blocks(srv.engine.path))
        if got != want:
            raise AssertionError(f"{srv.server} partition {srv.pidx}: manual"
                                 f" compaction {got} != cpu backend {want}")

    t0 = time.perf_counter()
    _parallel(one, range(len(servers)))
    return time.perf_counter() - t0


class _GcPauses:
    """Full (generation 2) garbage collections of this process while the
    context is open: every thread, the servers' RPC workers included,
    stops for each one."""

    def __enter__(self):
        import gc

        self.pauses, self._t0 = [], None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append(time.perf_counter() - self._t0)

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {"count": len(self.pauses), "s": sum(self.pauses),
                "max_s": max(self.pauses, default=0.0)}


def _percentiles(lat) -> dict:
    if not lat:
        return {"count": 0}
    a = np.sort(np.asarray(lat)) * 1e3
    return {"count": len(a), "p50_ms": float(a[len(a) // 2]),
            "p99_ms": float(a[min(len(a) - 1, int(len(a) * 0.99))]),
            "mean_ms": float(a.mean())}


# The client side of the serve phase runs in a process of its own (its
# 8 threads share one interpreter, as YCSB's client threads do), so the
# clients' Python does not contend with the servers' for one lock.
# _CLIENT holds that process's state between its two calls.
_CLIENT = {}
_PROGRESS = None   # the cluster client's op count, shared with the parent


def _client_run(addresses, n_records: int, n_ops: int, n_threads: int,
                n_sample: int, meta_app: tuple = None) -> dict:
    """In the client process: n_ops closed-loop operations from n_threads
    PegasusClient threads, 50 % get and 50 % set on zipfian ranks, each
    key's updates from one thread (rank mod n_threads), every read the
    loaded value or one issued for its key; then picks the keys to read
    back (every updated key, a seeded sample of untouched keys). The
    partitions are `addresses` (a StaticResolver), or with meta_app =
    (meta address, app) resolved through the meta: then every op is
    retried until it succeeds (CLUSTER_OP_DEADLINE_S each; retries
    counted), each set's (rank, issue, ack) wall times are kept for the
    failover time, and the ops done count into the shared _PROGRESS."""
    import threading

    from pegasus_tpu_torch.client import (MetaResolver, PegasusClient,
                                          StaticResolver)

    resolver = (MetaResolver([meta_app[0]], meta_app[1]) if meta_app
                else StaticResolver(SERVE_APP_ID, addresses))
    zipf = ZipfRanks(n_records)
    issued = {}       # rank -> every value issued for it (owner only)
    acked = {}        # rank -> last acknowledged value
    lat = {"get": [], "set": []}
    sets = []
    errors, retries = [], [0]
    per_thread = n_ops // n_threads
    lock = threading.Lock()

    def op(fn):
        if not meta_app:
            return fn()
        end = time.monotonic() + CLUSTER_OP_DEADLINE_S
        while True:
            try:
                return fn()
            except AssertionError:
                raise
            except Exception:  # noqa: BLE001 - a failover: retried
                if time.monotonic() > end:
                    raise
                with lock:
                    retries[0] += 1
                time.sleep(0.05)

    def worker(tid):
        rng = np.random.default_rng(1000 + tid)
        c = PegasusClient(resolver)
        seq = 0
        my_lat = {"get": [], "set": []}
        my_sets = []
        try:
            for _ in range(per_thread):
                if rng.random() < 0.5:
                    r = zipf.pick(rng)
                    t = time.perf_counter()
                    v = op(lambda: c.get(hash_key(r), SERVE_FIELD))
                    my_lat["get"].append(time.perf_counter() - t)
                    if v != loaded_value(r) and v not in issued.get(r, ()):
                        raise AssertionError(f"read of rank {r}: {v!r}")
                else:
                    r = zipf.pick(rng)
                    while r % n_threads != tid:
                        r = zipf.pick(rng)
                    val = update_value(tid, seq)
                    seq += 1
                    issued.setdefault(r, set()).add(val)
                    t, w0 = time.perf_counter(), time.time()
                    op(lambda: c.set(hash_key(r), SERVE_FIELD, val))
                    my_lat["set"].append(time.perf_counter() - t)
                    my_sets.append((r, w0, time.time()))
                    acked[r] = val
                if _PROGRESS is not None:
                    with _PROGRESS.get_lock():
                        _PROGRESS.value += 1
        except Exception as e:  # raised below
            errors.append(e)
        finally:
            c.close()
            with lock:
                for k in lat:
                    lat[k].extend(my_lat[k])
                sets.extend(my_sets)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=3600)
    run_s = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"YCSB run failed: {errors[:3]}")
    rng = np.random.default_rng(77)
    pick = rng.choice(n_records, min(n_records, n_sample + len(acked)),
                      replace=False).tolist()
    sample = [r for r in pick if r not in acked][:n_sample]
    _CLIENT.update(resolver=resolver,
                   meta=meta_app[0] if meta_app else None)
    _client_keys(acked, sample)
    done = len(lat["get"]) + len(lat["set"])
    out = {"seconds": run_s, "ops_done": done, "ops_per_s": done / run_s,
           "get": _percentiles(lat["get"]), "set": _percentiles(lat["set"]),
           "keys_updated": len(acked)}
    if meta_app:
        out.update(retries=retries[0], sets=sets)
    return out


def _client_keys(acked: dict, sample: list) -> None:
    """In the client process: the keys to read back, every updated rank
    (its last acknowledged value) and the sampled untouched ranks (their
    loaded values)."""
    upd = sorted(acked)
    rows, lens = ycsb_hash_keys(np.asarray(sample, np.int64))
    _CLIENT.update(
        acked=acked, sample=sample,
        updated=([(hash_key(r), SERVE_FIELD) for r in upd],
                 [acked[r] for r in upd]),
        sampled=([(rows[i, :lens[i]].tobytes(), SERVE_FIELD)
                  for i in range(len(sample))],
                 [loaded_value(r) for r in sample]))


def _client_snapshot() -> int:
    """In the client process: keep the read-back keys' values as they are
    now (the read-back's answers, just before the cold backup) for the
    restored table's read-back. -> keys kept."""
    _CLIENT["at_backup"] = {k: _CLIENT[k] for k in ("updated", "sampled")}
    return sum(len(v[0]) for v in _CLIENT["at_backup"].values())


def _client_absorb(acked: dict) -> int:
    """In the client process: later acknowledged writes ({rank: value})
    join the keys to read back; a sampled rank they wrote becomes an
    updated one. -> how many of them overwrote a key the backup holds."""
    backed = set(_CLIENT["acked"]) | set(_CLIENT["sample"])
    merged = dict(_CLIENT["acked"])
    merged.update(acked)
    _client_keys(merged, [r for r in _CLIENT["sample"] if r not in acked])
    return len(backed & set(acked))


def _client_read_back(what: str, chunk: int = 4000, app: str = None,
                      at_backup: bool = False, sample: bool = True) -> dict:
    """In the client process: batch_get every updated key (its last
    acknowledged value) and, with `sample`, every sampled untouched key
    (its loaded value); any other answer raises. With `app`, from that
    table of the same meta; with at_backup, the values _client_snapshot
    kept."""
    from pegasus_tpu_torch.client import MetaResolver, PegasusClient

    resolver = (MetaResolver([_CLIENT["meta"]], app) if app
                else _CLIENT["resolver"])
    resolver.refresh()   # a split since the last call changes the routes
    client = PegasusClient(resolver, timeout=120)
    keysets = _CLIENT["at_backup"] if at_backup else _CLIENT
    out = {"sampled_keys": 0, "sampled_s": 0.0}
    try:
        for name in ("updated", "sampled") if sample else ("updated",):
            keys, want = keysets[name]
            t0 = time.perf_counter()
            for lo in range(0, len(keys), chunk):
                got = client.batch_get(keys[lo: lo + chunk])
                for k, g, w in zip(keys[lo: lo + chunk], got,
                                   want[lo: lo + chunk]):
                    if g != w:
                        raise AssertionError(f"{what}: {name} key {k!r} "
                                             f"read {g!r}, want {w!r}")
            out[f"{name}_keys"] = len(keys)
            out[f"{name}_s"] = time.perf_counter() - t0
    finally:
        client.close()
    out["keys_per_s"] = (out["updated_keys"] + out["sampled_keys"]) / (
        out["updated_s"] + out["sampled_s"])
    return out


def _client_hot_write(hk: bytes, n_rows: int) -> int:
    """In the client process: n_rows sort keys under one hash key, each
    set acknowledged, kept as the hot rows. -> rows written."""
    from pegasus_tpu_torch.client import PegasusClient

    client = PegasusClient(_CLIENT["resolver"], timeout=120)
    try:
        rows = [(b"s%04d" % i, b"hot-value-%d" % i) for i in range(n_rows)]
        for sk, v in rows:
            client.set(hk, sk, v)
    finally:
        client.close()
    _CLIENT["hot"] = (hk, rows)
    return len(rows)


def _client_until_stopped(items: list, want: list, max_s: float,
                          what: str) -> dict:
    """In the client process: batch_get of `items` over and over, every
    answer its `want`, until the parent sets the shared _PROGRESS below 0
    or max_s passes. -> batches, keys and seconds."""
    from pegasus_tpu_torch.client import PegasusClient

    client = PegasusClient(_CLIENT["resolver"], timeout=120)
    t0 = time.perf_counter()
    batches = 0
    try:
        while _PROGRESS.value >= 0 and time.perf_counter() - t0 < max_s:
            got = client.batch_get(items)
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want))
                           if g != w)
                raise AssertionError(f"{what}: {items[bad]!r} read "
                                     f"{got[bad]!r}, want {want[bad]!r}")
            batches += 1
    finally:
        client.close()
    return {"batches": batches, "keys": batches * len(items),
            "seconds": time.perf_counter() - t0}


def _client_hammer(max_s: float) -> dict:
    """In the client process: the hot rows (_client_hot_write) read back
    in one batch, again and again (the parent stops it)."""
    hk, rows = _CLIENT["hot"]
    return _client_until_stopped([(hk, sk) for sk, _ in rows],
                                 [v for _, v in rows], max_s, "hot read")


def _client_calm(pidx: int, max_s: float, n_keys: int = 512) -> dict:
    """In the client process: sampled untouched keys of every partition
    but `pidx`, read back in batches (their loaded values) until the
    parent stops it: the other partitions' load calms the hot one."""
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.client import PegasusClient

    keys, want = _CLIENT["sampled"]
    route = PegasusClient(_CLIENT["resolver"])
    try:
        picked = [i for i, (hk, sk) in enumerate(keys)
                  if route._route(generate_key(hk, sk))[0] != pidx][:n_keys]
    finally:
        route.close()
    return _client_until_stopped([keys[i] for i in picked],
                                 [want[i] for i in picked], max_s,
                                 "calming read")


def run_serve(device, work: str, n_records: int = SERVE_RECORDS,
              n_parts: int = SERVE_PARTITIONS, n_ops: int = SERVE_OPS,
              n_threads: int = SERVE_THREADS,
              n_sample: int = SERVE_SAMPLE) -> dict:
    """The partition data plane, BASELINE config #3 (YCSB workload-A, 32
    hash partitions): n_parts PegasusServers (cuda backend) behind two
    in-process RpcServers, one replica each; the records bulk-loaded from
    SERVE_FILES unsorted raw sets per partition with one
    RPC_BULK_LOAD_INGEST per partition (the merges on the card), each
    partition's installed run held to the cpu backend (check_ingest); the
    YCSB-A run and the read-backs from a client process (_client_run,
    _client_read_back); between the read-backs, a manual compaction of
    every partition through update_app_envs
    (manual_compact.once.trigger_time) under torch.profiler, each
    partition's output held to the cpu backend's compaction of its runs
    from just before (check_compaction). Merge-kernel launches are
    counted from 0 around the ingest and around the compaction."""
    import multiprocessing
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.base import consts
    from pegasus_tpu_torch.client import PegasusClient, StaticResolver
    from pegasus_tpu_torch.engine.db import EngineOptions
    from pegasus_tpu_torch.engine.replica_service import ReplicaService
    from pegasus_tpu_torch.engine.server_impl import PegasusServer
    from pegasus_tpu_torch.ops.fence_lookup import LAUNCHES as FENCE
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.rpc import codec
    from pegasus_tpu_torch.rpc import messages as msg
    from pegasus_tpu_torch.rpc.task_codes import RPC_BULK_LOAD_INGEST
    from pegasus_tpu_torch.rpc.transport import RpcServer
    from pegasus_tpu_torch.runtime.perf_counters import counters
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    os.makedirs(work, exist_ok=True)
    out = {"config": "BASELINE #3: YCSB workload-A (50/50 read/update), "
           f"{n_parts} hash partitions",
           "partitions": n_parts, "records": n_records, "ops": n_ops,
           "threads": n_threads, "zipf_theta": SERVE_THETA,
           "guarantee": "read-your-acknowledged-writes on one copy (no "
                        "mutation log, one replica per partition)",
           "reduced": {"fields": "YCSB core fieldcount 10 -> 1 "
                       "(field0, fieldlength 100), as tools/ycsb_bench.py",
                       "replicas": "3 -> 1 (the cluster phase runs "
                                   "this table with its 3)",
                       "ops": f"{n_ops} (200 000 before the clock cuts)"}}
    t0 = time.perf_counter()
    provider = os.path.join(work, "provider")
    counts = write_provider(provider, "usertable", n_records, n_parts,
                            SERVE_FILES)
    out["load_s"] = time.perf_counter() - t0

    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rpcs, servers, addr = [], [], {}
    loader = pool = None
    try:
        for node in range(2):
            svc = ReplicaService()
            rpc = RpcServer().start()
            rpcs.append(rpc)
            for p in range(node, n_parts, 2):
                srv = PegasusServer(os.path.join(work, f"p{p}"),
                                    app_id=SERVE_APP_ID, pidx=p,
                                    server=f"node{node}",
                                    options=EngineOptions(device=device))
                svc.add_replica(srv, n_parts)
                servers.append(srv)
                addr[p] = rpc.address
            rpc.register_serverlet(svc)
        addresses = [addr[p] for p in range(n_parts)]
        loader = PegasusClient(StaticResolver(SERVE_APP_ID, addresses))

        def ingest(p):
            conn = loader.pool.get(addresses[p], shard=p)
            _, body = conn.call(RPC_BULK_LOAD_INGEST, codec.encode(
                msg.BulkLoadIngestRequest(provider, "usertable", n_parts)),
                app_id=SERVE_APP_ID, partition_index=p,
                timeout=SERVE_TIMEOUT_S)
            return codec.decode(msg.BulkLoadIngestResponse, body)

        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_parts) as ex:
            resps = list(ex.map(ingest, range(n_parts)))
        out["ingest_s"] = time.perf_counter() - t0
        out["ingest_merge_launches"] = LAUNCHES["merge_path"]
        for p, r in enumerate(resps):
            if r.error or r.ingested_records != counts[p]:
                raise AssertionError(f"partition {p} ingested "
                                     f"{r.ingested_records} of {counts[p]} "
                                     f"(error {r.error})")
        out["ingested_records"] = sum(r.ingested_records for r in resps)
        out["partition_records"] = counts
        out["ingest_check_s"] = check_ingest(servers, provider, "usertable",
                                             n_parts)

        pool = multiprocessing.get_context("spawn").Pool(1)
        with _GcPauses() as gcp:
            out["run"] = pool.apply(_client_run, (addresses, n_records,
                                                  n_ops, n_threads, n_sample))
        out["run"]["server_gc_pauses"] = gcp.summary()

        def read_back(what, sample=True):
            batch_size = counters.percentile("read.batch.size")
            batch_size.reset()
            FENCE["fence_lookup"] = 0
            with COMPACT_TRACER.session() as sess, _GcPauses() as gcp:
                rb = pool.apply(_client_read_back, (what,),
                                {"sample": sample})
            lk = sess.summary().get("read.lookup", {})
            rb = dict(rb, batch_size=batch_size.percentiles(),
                      device_lookup_calls=lk.get("calls", 0),
                      device_lookup_keys=lk.get("records", 0),
                      fence_launches=FENCE["fence_lookup"],
                      server_gc_pauses=gcp.summary())
            if on_card and rb["device_lookup_calls"] and \
                    not rb["fence_launches"]:
                raise AssertionError(f"read-back {what}: device lookups "
                                     f"served without a fence-lookup "
                                     f"kernel launch")
            # batch dispatch: a client wave reaches the coalescer whole,
            # and its batches probe the resident runs on the device
            if rb["updated_keys"] + rb["sampled_keys"] and (
                    rb["batch_size"]["p50"] <= 1
                    or not rb["device_lookup_calls"]):
                raise AssertionError(f"read-back {what}: batch size "
                                     f"{rb['batch_size']}, "
                                     f"{rb['device_lookup_calls']} device "
                                     f"lookups")
            return rb

        out["read_back_after_run"] = read_back("after the run")

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if on_card else [])
        kept = keep_runs(servers, os.path.join(work, "pre_compaction"))
        trigger = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY:
                   str(int(time.time()) - 1)}
        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for srv in servers:
                srv.update_app_envs(trigger)
            if on_card:
                torch.cuda.synchronize(device)
            compact_s = time.perf_counter() - t0
        launches = LAUNCHES["merge_path"]
        events = _device_events(prof)
        busy_s = sum(e[1] for e in events) / 1e3
        states = [srv.manual_compact_service.query_compact_state()
                  for srv in servers]
        if any(not st.startswith("idle; last finish") for st in states):
            raise AssertionError(f"a manual compaction did not finish: "
                                 f"{states}")
        out["compaction"] = {
            "seconds": compact_s, "merge_launches": launches,
            "device_busy_s": busy_s,
            "idle_share": max(0.0, 1 - busy_s / compact_s),
            "top_device_events": [{"name": k[:90], "ms": ms, "calls": c}
                                  for k, ms, c in events[:6]],
            "l0_files_after": sum(srv.engine.stats()["l0_files"]
                                  for srv in servers),
            "check_s": check_compaction(servers, kept)}
        shutil.rmtree(os.path.join(work, "pre_compaction"))
        # its untouched sample read once, after the run (cut for the
        # clock: the compaction outputs are held to the cpu backend)
        out["read_back_after_compaction"] = read_back("after the compaction",
                                                      sample=False)
        if on_card:
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        if loader is not None:
            loader.close()
        for r in rpcs:
            r.stop()
        for srv in servers:
            srv.close()
    return out


# ---------------------------------------------------------- replicate

# partition 0 of the serve table, 10 000 ops (4 groups and 40 000 before
# the cluster phase took on the table lifecycle: the in-process groups are
# a subset of what the cluster's processes do, cut for the clock)
REPLICATE_GROUPS = 1
REPLICATE_OPS = 10_000
REPLICATE_THREADS = 8
REPLICATE_WAVE = 8          # ops per client wave; its gets, one batch per group
REPLICATE_SAMPLE = 50_000  # untouched loaded keys read back from every
                           # replica (100 000 until the levels phase)
REPLICATE_KILL_AT = 3_750
REPLICATE_RESTART_AT = 6_250
REPLICATE_APP_ID = 4


def partition_ranks(n_records: int, n_parts: int, parts) -> dict:
    """{pidx: the ranks whose records the serve table routes to pidx}."""
    out = {p: [] for p in parts}
    chunk = 1 << 21
    for lo in range(0, n_records, chunk):
        ranks = np.arange(lo, min(n_records, lo + chunk), dtype=np.int64)
        part = _partition_of(*ycsb_hash_keys(ranks), n_parts)
        for p in parts:
            out[p].append(ranks[part == p])
    return {p: np.concatenate(v) for p, v in out.items()}


def _replicas(groups) -> list:
    return [r for g in groups for _, r in sorted(g.alive.items())]


def run_replicate(device, work: str, provider: str,
                  n_records: int = SERVE_RECORDS,
                  n_parts: int = SERVE_PARTITIONS,
                  n_groups: int = REPLICATE_GROUPS,
                  n_ops: int = REPLICATE_OPS,
                  n_threads: int = REPLICATE_THREADS,
                  n_sample: int = REPLICATE_SAMPLE,
                  kill_at: int = REPLICATE_KILL_AT,
                  restart_at: int = REPLICATE_RESTART_AT) -> dict:
    """PacificA at full width: partitions 0..n_groups-1 of the serve table
    (`provider`, written by run_serve), each a ReplicaGroup of 3 replicas
    with cuda engines and quorum 2. Loaded through PacificA itself: one
    RPC_BULK_LOAD_INGEST write per group, so every replica ingests the
    same raw sets through the merge kernel. Then YCSB-A from n_threads
    threads against the primaries (zipfian over the groups' records,
    sets through ReplicaGroup.write, gets through
    primary.server.on_get_batch in waves of REPLICATE_WAVE ops); at op
    kill_at group 0's primary is hard-killed (a write that fails in the
    failover is retried and counted), at op restart_at it restarts and
    rejoins as a learner (the streamed learn of a checkpoint plus the log
    tail) while writes go on. Then every acknowledged update and an
    n_sample sample of loaded keys read back from every replica through
    on_get_batch; state_digest equal across each group's replicas; a
    manual compaction of every replica under torch.profiler, each output
    held to the cpu backend's compaction of its runs from just before.
    Merge-kernel launches are counted from 0 around the load and around
    the compaction."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.utils import epoch_now
    from pegasus_tpu_torch.engine.db import EngineOptions
    from pegasus_tpu_torch.ops.fence_lookup import LAUNCHES as FENCE
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.replication import ReplicaError, ReplicaGroup
    from pegasus_tpu_torch.rpc import messages as msg
    from pegasus_tpu_torch.rpc.messages import Status
    from pegasus_tpu_torch.rpc.task_codes import (RPC_BULK_LOAD_INGEST,
                                                  RPC_PUT)
    from pegasus_tpu_torch.runtime.perf_counters import counters
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def mem():
        return torch.cuda.memory_allocated(device) if on_card else 0

    def device_busy(prof, wall):
        busy = sum(e[1] for e in _device_events(prof)) / 1e3
        return {"device_busy_s": busy,
                "idle_share": max(0.0, 1 - busy / wall) if wall else None}

    out = {"config": "BASELINE #3 per-partition scale, 3 replicas, quorum 2 "
           "(YCSB workload-A)",
           "groups": n_groups, "replicas": 3, "quorum": 2, "ops": n_ops,
           "threads": n_threads, "zipf_theta": SERVE_THETA,
           "guarantee": "PacificA: a write is acknowledged once a quorum "
                        "(2 of 3) holds it in its log; every acknowledged "
                        "write is read back from all three replicas",
           "reduced": {"partitions": f"{n_parts} -> {n_groups} (the "
                       "script's clock); replicas stay 3",
                       "fields": "YCSB core fieldcount 10 -> 1 (field0, "
                       "fieldlength 100), as tools/ycsb_bench.py"}}
    parts = list(range(n_groups))
    t0 = time.perf_counter()
    ranks = partition_ranks(n_records, n_parts, parts)
    all_ranks = np.concatenate([ranks[p] for p in parts])
    group_of = np.concatenate([np.full(len(ranks[p]), p, np.int64)
                               for p in parts])
    out["records"] = {p: int(len(ranks[p])) for p in parts}
    out["key_setup_s"] = time.perf_counter() - t0

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    groups = []
    try:
        for p in parts:
            groups.append(ReplicaGroup(
                os.path.join(work, f"g{p}"), n=3, app_id=REPLICATE_APP_ID,
                pidx=p, quorum=2,
                options_factory=lambda: EngineOptions(device=device)))

        # ---- load: one bulk-load ingest write per group, through PacificA
        req = msg.BulkLoadIngestRequest(provider, "usertable", n_parts)

        def load(g):
            resp = g.write(RPC_BULK_LOAD_INGEST, req)
            # the commit point reaches the secondaries, which ingest now
            g.primary_replica().broadcast_commit_point()
            return resp

        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(n_groups) as ex:
                resps = list(ex.map(load, groups))
            sync()
            load_s = time.perf_counter() - t0
        out["load"] = {"seconds": load_s,
                       "merge_launches": LAUNCHES["merge_path"],
                       **device_busy(prof, load_s)}
        for p, r in zip(parts, resps):
            if r.error or r.ingested_records != len(ranks[p]):
                raise AssertionError(f"group {p} ingested "
                                     f"{r.ingested_records} of "
                                     f"{len(ranks[p])} (error {r.error})")
        for rep in _replicas(groups):
            if rep.last_committed != 1:
                raise AssertionError(f"{rep.name} of group {rep.pidx} did "
                                     f"not apply the ingest")

        # ---- YCSB-A against the primaries, a kill and a rejoin under load
        zipf = ZipfRanks(len(all_ranks))
        lock = threading.Lock()
        done = [0]
        issued, acked = {}, {}
        lat = {"get": [], "set": []}
        g0_acks = []          # (write start, ack) of group 0's writes
        retries = [0]
        errors = []
        ctl = {}
        per_thread = n_ops // n_threads

        def key_of(i):
            r = int(all_ranks[i])
            return r, generate_key(hash_key(r), SERVE_FIELD)

        def write(g, key, val):
            t_start = time.perf_counter()
            while True:
                try:
                    resp = groups[g].write(RPC_PUT,
                                           msg.UpdateRequest(key, val, 0))
                    break
                except (ReplicaError, KeyError):  # failover: retried
                    with lock:
                        retries[0] += 1
                    if time.perf_counter() - t_start > 60:
                        raise
                    time.sleep(0.001)
            t_ack = time.perf_counter()
            if resp.error != Status.OK:
                raise AssertionError(f"set answered {resp.error}")
            if g == 0:
                with lock:
                    g0_acks.append((t_start, t_ack))
            return t_ack - t_start

        def read_wave(gets):
            by_group = {}
            for i in gets:
                by_group.setdefault(int(group_of[i]), []).append(i)
            for g, idx in by_group.items():
                keys = [key_of(i)[1] for i in idx]
                t = time.perf_counter()
                while True:
                    try:
                        resps = groups[g].primary_replica().server \
                            .on_get_batch(keys)
                        break
                    except KeyError:   # mid-failover: no primary yet
                        time.sleep(0.001)
                dt = time.perf_counter() - t
                for i, resp in zip(idx, resps):
                    r = int(all_ranks[i])
                    lat["get"].append(dt)
                    if resp.value != loaded_value(r) and \
                            resp.value not in issued.get(r, ()):
                        raise AssertionError(f"read of rank {r}: "
                                             f"{resp.error} {resp.value!r}")

        def worker(tid):
            rng = np.random.default_rng(2000 + tid)
            seq = 0
            try:
                left = per_thread
                while left:
                    wave = min(REPLICATE_WAVE, left)
                    left -= wave
                    gets = []
                    for _ in range(wave):
                        if rng.random() < 0.5:
                            gets.append(zipf.pick(rng))
                            continue
                        i = zipf.pick(rng)
                        while int(all_ranks[i]) % n_threads != tid:
                            i = zipf.pick(rng)
                        r, key = key_of(i)
                        val = update_value(tid, seq)
                        seq += 1
                        issued.setdefault(r, set()).add(val)
                        lat["set"].append(write(int(group_of[i]), key, val))
                        acked[r] = (int(group_of[i]), val)
                    if gets:
                        read_wave(gets)
                    with lock:
                        done[0] += wave
            except Exception as e:  # raised below
                errors.append(e)

        def controller():
            try:
                while done[0] < kill_at and not errors:
                    time.sleep(0.005)
                g0 = groups[0]
                victim = g0.primary
                ctl["victim"] = victim
                sync()
                ctl["mem_before_kill"] = mem()
                ctl["t_kill"] = time.perf_counter()
                g0.kill(victim)
                ctl["t_killed"] = time.perf_counter()
                ctl["new_primary"] = g0.primary
                while done[0] < restart_at and not errors:
                    time.sleep(0.005)
                b0 = {k: counters.rate("learn." + k).total() for k in
                      ("ship.bytes", "ship.blocks", "replay.mutations",
                       "ship.delta_skipped_blocks")}
                ctl["t_restart"] = time.perf_counter()
                learner = g0.restart(victim)
                ctl["t_learned"] = time.perf_counter()
                sync()
                ctl["mem_after_learn"] = mem()
                ctl["learner_resident"] = \
                    learner.server.engine.device_resident_bytes()
                ctl["learn"] = {k.replace(".", "_"): counters.rate(
                    "learn." + k).total() - v for k, v in b0.items()}
            except Exception as e:  # raised below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        threads.append(threading.Thread(target=controller))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3600)
        run_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"replicate run failed: {errors[:3]}")
        after_kill = [a for s, a in g0_acks if s >= ctl["t_kill"]]
        in_learn = [a for _, a in g0_acks
                    if ctl["t_restart"] <= a <= ctl["t_learned"]]
        in_down = [a for _, a in g0_acks
                   if ctl["t_killed"] <= a <= ctl["t_restart"]]
        if not after_kill or not in_learn or not in_down:
            raise AssertionError(
                f"group 0 stopped committing: {len(in_down)} writes acked "
                f"between the kill and the restart, {len(in_learn)} during "
                f"the learn")
        n_done = len(lat["get"]) + len(lat["set"])
        out["run"] = {
            "seconds": run_s, "ops_done": n_done,
            "ops_per_s": n_done / run_s,
            "get": _percentiles(lat["get"]), "set": _percentiles(lat["set"]),
            "keys_updated": len(acked), "write_retries": retries[0],
            "killed": f"group 0 primary {ctl['victim']} at op {kill_at}; "
                      f"new primary {ctl['new_primary']}",
            "failover_s": min(after_kill) - ctl["t_kill"],
            "group0_acks_while_down": len(in_down),
            "group0_acks_during_learn": len(in_learn),
            "learn": dict(ctl["learn"],
                          seconds=ctl["t_learned"] - ctl["t_restart"]),
            "device_bytes_before_kill": ctl["mem_before_kill"],
            "device_bytes_after_learn": ctl["mem_after_learn"],
            "learner_resident_bytes": ctl["learner_resident"]}
        if ctl["mem_after_learn"] - ctl["mem_before_kill"] > \
                ctl["learner_resident"]:
            raise AssertionError(
                f"device memory after the learn {ctl['mem_after_learn']} "
                f"exceeds the memory before the kill "
                f"{ctl['mem_before_kill']} by more than the learner's own "
                f"resident runs {ctl['learner_resident']}")

        # ---- read-back from every replica, the relearned one included
        for g in groups:
            g.primary_replica().broadcast_commit_point()
        rng = np.random.default_rng(78)
        by_group = {p: ([], []) for p in parts}
        for r, (g, val) in acked.items():
            by_group[g][0].append(generate_key(hash_key(r), SERVE_FIELD))
            by_group[g][1].append(val)
        touched = set(acked)
        pick = rng.choice(len(all_ranks), min(len(all_ranks),
                                              n_sample + len(acked)),
                          replace=False)
        sample = [i for i in pick.tolist()
                  if int(all_ranks[i]) not in touched][:n_sample]
        for i in sample:
            r = int(all_ranks[i])
            by_group[int(group_of[i])][0].append(
                generate_key(hash_key(r), SERVE_FIELD))
            by_group[int(group_of[i])][1].append(loaded_value(r))
        n_keys = 0
        batch_size = counters.percentile("read.batch.size")
        batch_size.reset()
        FENCE["fence_lookup"] = 0
        with COMPACT_TRACER.session() as sess:
            t0 = time.perf_counter()
            for g in groups:
                keys, want = by_group[g.pidx]
                for rep in g.alive.values():
                    for lo in range(0, len(keys), 4000):
                        got = rep.server.on_get_batch(keys[lo: lo + 4000])
                        for k, resp, w in zip(keys[lo: lo + 4000], got,
                                              want[lo: lo + 4000]):
                            if resp.value != w:
                                raise AssertionError(
                                    f"{rep.name} of group {g.pidx}: key "
                                    f"{k!r} read {resp.error} "
                                    f"{resp.value!r}, want {w!r}")
                    n_keys += len(keys)
            rb_s = time.perf_counter() - t0
        lk = sess.summary().get("read.lookup", {})
        out["read_back"] = {
            "keys": n_keys, "seconds": rb_s, "keys_per_s": n_keys / rb_s,
            "updated_keys": len(acked), "sampled_keys": len(sample),
            "batch_size": batch_size.percentiles(),
            "device_lookup_calls": lk.get("calls", 0),
            "device_lookup_keys": lk.get("records", 0),
            "fence_launches": FENCE["fence_lookup"]}
        if not lk.get("calls"):
            raise AssertionError("the read-back made no device lookup")
        if on_card and not FENCE["fence_lookup"]:
            raise AssertionError("the read-back served device lookups "
                                 "without a fence-lookup kernel launch")

        # ---- every group's replicas hold the same state
        now = epoch_now()
        t0 = time.perf_counter()
        digests = {}
        for g in groups:
            ds = {n: r.server.engine.state_digest(now=now)
                  for n, r in sorted(g.alive.items())}
            if len({d["digest"] for d in ds.values()}) != 1 or \
                    len(ds) != 3:
                raise AssertionError(f"group {g.pidx} replicas diverged: "
                                     f"{ds}")
            digests[g.pidx] = next(iter(ds.values()))
        out["digests"] = {"seconds": time.perf_counter() - t0,
                          "records": {p: d["records"]
                                      for p, d in digests.items()}}

        # ---- a manual compaction of every replica, held to the cpu backend
        reps = _replicas(groups)
        servers = [r.server for r in reps]
        kept = keep_runs(servers, os.path.join(work, "pre_compaction"))
        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for srv in servers:
                srv.manual_compact()
            sync()
            compact_s = time.perf_counter() - t0
        out["compaction"] = {
            "seconds": compact_s, "merge_launches": LAUNCHES["merge_path"],
            "expected_launches": sum(len(k) - 1 for k in kept),
            "runs": {f"{r.pidx}.{r.name}": len(k)
                     for r, k in zip(reps, kept)},
            **device_busy(prof, compact_s),
            "check_s": check_compaction(servers, kept)}
        shutil.rmtree(os.path.join(work, "pre_compaction"))
        if on_card:
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        for g in groups:
            g.close()
    return out


# ---------------------------------------------------------------- geo

# BASELINE config #5 (geo/ S2-indexed keys, range-scan + compact), at
# tools/geo_bench.py's geography and levels: the points uniform in a box
# around 40.06 N 116.40 E, raised from its 20 000 points in +-0.1 deg to
# 1 000 000 in +-0.7 deg, which keeps its ~54 points per km^2
GEO_POINTS = 1_000_000
GEO_CENTER = (40.06, 116.40)
GEO_BOX = 0.7          # points uniform in GEO_CENTER +- GEO_BOX degrees
GEO_QUERY_BOX = 0.8    # search centres uniform in GEO_CENTER +- this
                       # share of the points' box (0.56 deg)
GEO_PARTITIONS = 8
GEO_FILES = 4          # raw-set files per partition
# cut for the clock (the first full run took 1254 s of 1200 on a slow
# host; its geo phase 166 s): moves and adds 10 000 + 5 000 -> 5 000 +
# 2 500, searches a round 1 000 + 100 -> 500 + 50
GEO_MOVES = 5_000      # points deleted and set again at a new place
GEO_ADDS = 2_500
GEO_SEARCHES = ((500.0, -1, 500), (5000.0, 100, 50))  # (m, count, n)
GEO_THREADS = 8
GEO_MIN_LEVEL, GEO_MAX_LEVEL = 12, 16   # GeoClient's and geo_bench's
GEO_APPS = (("geo_main", 5), ("geo_idx", 6))
GEO_RESP_KEYS = 1000
GEO_RESP_MEMBERS = 2000
GEO_RESP_GEO = 20      # GEORADIUS, GEODIST and GEOPOS commands each
GEO_RESP_BOX = 0.05    # the GEOADD members around GEO_CENTER
GEO_RESP_TTL = 600
# geo_idx's EngineOptions: its keys are 36 bytes (2 + a 6-byte cell
# token + a 28-byte sort key), past the default 32-byte prefix window, so
# at prefix_u32 = 8 its runs are not cacheable on the card and every scan
# walks the host; and a scan arrives one range per frame, so at the
# default min batch (2) a lone range takes the host search too
GEO_IDX_OPTS = {"prefix_u32": 9, "device_read_min_batch": 1}


def geo_points(n: int, seed: int, box: float = GEO_BOX):
    """n points uniform in GEO_CENTER +- box. -> (lat, lng) float64."""
    rng = np.random.default_rng(seed)
    return (GEO_CENTER[0] + rng.uniform(-box, box, n),
            GEO_CENTER[1] + rng.uniform(-box, box, n))


def geo_value(i: int, lat: float, lng: float) -> bytes:
    """The value GeoClient.set_geo_data(lat, lng, hk, sk, b"v%d" % i)
    stores: LatlngCodec's fields 4 (lng) and 5 (lat) patched in."""
    return b"v%d||||%r|%r" % (i, lng, lat)


def _arena(items) -> tuple:
    """bytes items -> (uint8 arena, int64 offsets, int32 lengths)."""
    lens = np.fromiter((len(x) for x in items), np.int32, len(items))
    offs = np.zeros(len(items), np.int64)
    if len(items):
        np.cumsum(lens[:-1], out=offs[1:])
    return np.frombuffer(b"".join(items), np.uint8), offs, lens


def geo_rows(lat, lng) -> dict:
    """Both tables' rows of points i = 0..n-1, as GeoClient writes them:
    geo_main (p%07d, s) -> value; geo_idx (the level-GEO_MIN_LEVEL cell
    token, the 15-hex Morton code + the hash key's length + hash key +
    sort key) -> value. -> {app: (hash keys, sort keys, values)}."""
    from pegasus_tpu_torch.geo import cells

    n = len(lat)
    codes = cells.morton_batch(lat, lng)
    cids = codes >> np.uint64(2 * (30 - GEO_MIN_LEVEL))
    hks = [b"p%07d" % i for i in range(n)]
    values = [geo_value(i, a, b) for i, (a, b) in
              enumerate(zip(lat.tolist(), lng.tolist()))]
    tokens = [cells.cell_token(c, GEO_MIN_LEVEL) for c in cids.tolist()]
    gsks = [b"%015x%04x%ss" % (m, len(hk), hk)
            for m, hk in zip(codes.tolist(), hks)]
    return {"geo_main": (hks, [b"s"] * n, values),
            "geo_idx": (tokens, gsks, values)}


def write_geo_provider(root: str, rows: dict, n_parts: int,
                       n_files: int, seed: int = 31) -> dict:
    """Each table's bulk-load provider tree: rows routed to their
    partition by the hash key's hash, each partition's rows shuffled
    (raw sets are unsorted) and cut into n_files raw-set files. -> {app:
    records per partition}."""
    from pegasus_tpu_torch.engine.bulk_load import (write_metadata,
                                                    write_raw_columns)

    rng = np.random.default_rng(seed)
    counts = {}
    for app, (hks, sks, values) in rows.items():
        ha = _arena(hks)
        width = int(ha[2].max())
        padded = np.zeros((len(hks), width), np.uint8)
        ok = np.arange(width)[None, :] < ha[2][:, None]
        padded[ok] = ha[0]
        part = _partition_of(padded, ha[2], n_parts)
        counts[app] = []
        for p in range(n_parts):
            idx = rng.permutation(np.flatnonzero(part == p))
            counts[app].append(len(idx))
            pdir = os.path.join(root, app, str(n_parts), str(p))
            os.makedirs(pdir, exist_ok=True)
            for f, fr in enumerate(np.array_split(idx, n_files)):
                fr = fr.tolist()
                write_raw_columns(
                    os.path.join(pdir, f"{f:02d}.raw"),
                    _arena([hks[i] for i in fr]),
                    _arena([sks[i] for i in fr]),
                    _arena([values[i] for i in fr]),
                    np.zeros(len(fr), np.uint32))
        write_metadata(root, app, n_parts)
    return counts


class GeoTruth:
    """The known point set, for brute-force answers: every point's
    latitude, longitude and value, points sorted by latitude so that a
    query reads only the band its radius can reach."""

    def __init__(self, lat, lng, values, hks):
        order = np.argsort(lat, kind="stable")
        self.lat, self.lng = lat[order], lng[order]
        self.values = [values[i] for i in order.tolist()]
        self.hks = [hks[i] for i in order.tolist()]

    def search(self, lat: float, lng: float, radius: float,
               count: int = -1) -> list:
        """search_radial's answer by brute force: [(d, hk, b"s", value)]
        sorted by distance, d from cells.haversine_m."""
        import math

        from pegasus_tpu_torch.geo import cells

        pad = math.degrees(radius / cells.EARTH_RADIUS_M) * 1.01 + 1e-6
        lo, hi = np.searchsorted(self.lat, [lat - pad, lat + pad])
        la, ln = self.lat[lo:hi], self.lng[lo:hi]
        # a numpy prefilter with a margin; the distances themselves are
        # haversine_m's, as the client computes them
        p1, p2 = math.radians(lat), np.radians(la)
        a = (np.sin((p2 - p1) / 2) ** 2 + math.cos(p1) * np.cos(p2)
             * np.sin(np.radians(ln - lng) / 2) ** 2)
        d = 2 * cells.EARTH_RADIUS_M * np.arcsin(np.minimum(1.0,
                                                            np.sqrt(a)))
        out = []
        for j in np.flatnonzero(d <= radius * (1 + 1e-9) + 1e-6).tolist():
            dist = cells.haversine_m(lat, lng, float(la[j]), float(ln[j]))
            if dist <= radius:
                k = lo + j
                out.append((dist, self.hks[k], b"s", self.values[k]))
        out.sort()
        return out[:count] if count > 0 else out


def check_geo_answer(got: list, want: list, count: int) -> None:
    """A search answer against the brute force: the same (hash key, sort
    key, value) set with the same distances; for a counted search, the
    nearest `count` (their distances in order)."""
    if count > 0:
        if [g[0] for g in got] != [w[0] for w in want]:
            raise AssertionError(f"nearest {count}: distances "
                                 f"{[g[0] for g in got][:5]}... != "
                                 f"{[w[0] for w in want][:5]}...")
    if sorted(got) != want:
        missing = set(want) - set(got)
        extra = set(got) - set(want)
        raise AssertionError(f"geo answer: {len(got)} rows, brute force "
                             f"{len(want)}; missing {sorted(missing)[:3]}, "
                             f"extra {sorted(extra)[:3]}")


def _geo_searches(geo, truth, queries, n_threads: int) -> dict:
    """Every (lat, lng, radius, count) query from n_threads threads, each
    answer held to the brute force. -> latency percentiles and rows per
    query, by radius."""
    from concurrent.futures import ThreadPoolExecutor

    def one(q):
        t0 = time.perf_counter()
        rows = geo.search_radial(*q)
        return time.perf_counter() - t0, rows

    with ThreadPoolExecutor(n_threads) as ex:
        done = list(ex.map(one, queries))
    by_radius = {}
    for q, (s, rows) in zip(queries, done):
        check_geo_answer(rows, truth.search(*q), q[3])
        r = by_radius.setdefault(f"{q[2]:.0f}m", {"lat": [], "rows": 0})
        r["lat"].append(s)
        r["rows"] += len(rows)
    return {k: dict(_percentiles(v["lat"]),
                    rows_per_query=v["rows"] / len(v["lat"]))
            for k, v in by_radius.items()}


def _resp_cmd(*args) -> bytes:
    out = b"*%d\r\n" % len(args)
    for a in args:
        a = a if isinstance(a, bytes) else str(a).encode()
        out += b"$%d\r\n%s\r\n" % (len(a), a)
    return out


def _resp_reply(f) -> bytes:
    """One whole RESP reply, as the bytes it came in."""
    line = f.readline()
    if line[:1] == b"$":
        n = int(line[1:])
        return line + (f.read(n + 2) if n >= 0 else b"")
    if line[:1] == b"*":
        return line + b"".join(_resp_reply(f)
                               for _ in range(max(0, int(line[1:]))))
    return line


def _resp_bulk(v: bytes) -> bytes:
    return b"$%d\r\n%s\r\n" % (len(v), v)


def _resp_exchange(f, pairs, chunk: int = 200) -> int:
    """Send (command, expected reply or set of allowed replies) pairs,
    chunk commands at a time (pipelined), and hold every reply to its
    expectation. -> commands sent."""
    for lo in range(0, len(pairs), chunk):
        part = pairs[lo:lo + chunk]
        f.write(b"".join(c for c, _ in part))
        f.flush()
        for cmd, want in part:
            got = _resp_reply(f)
            ok = got in want if isinstance(want, (set, frozenset)) \
                else got == want
            if not ok:
                raise AssertionError(f"RESP {cmd[:80]!r}: {got[:200]!r}, "
                                     f"want {want!r:.200}")
    return len(pairs)


def run_resp(geo, kv_client, n_keys: int = GEO_RESP_KEYS,
             n_members: int = GEO_RESP_MEMBERS, n_geo: int = GEO_RESP_GEO,
             seed: int = 37) -> dict:
    """A RESP session over TCP to a RedisProxy in this process, every
    reply held to its expected bytes: SET, GET, SETEX, TTL, INCRBY and DEL
    on n_keys keys; GEOADD of n_members members under one key (100 per
    command), then n_geo GEORADIUS (1 km around a member), GEODIST and
    GEOPOS (a member and a missing one), each expected from the members'
    coordinates by brute force (cells.haversine_m)."""
    import socket

    from pegasus_tpu_torch.geo import cells
    from pegasus_tpu_torch.redis_proxy import RedisProxy

    proxy = RedisProxy(kv_client, geo=geo).start()
    sock = socket.create_connection(proxy.address, timeout=300)
    f = sock.makefile("rwb")
    out = {"keys": n_keys, "members": n_members}
    try:
        t0 = time.perf_counter()
        kv = []
        for i in range(n_keys):
            k, v = b"rk%d" % i, b"val%d" % i
            kv += [(_resp_cmd("SET", k, v), b"+OK\r\n"),
                   (_resp_cmd("GET", k), _resp_bulk(v)),
                   (_resp_cmd("SETEX", b"rt%d" % i, GEO_RESP_TTL, v),
                    b"+OK\r\n"),
                   (_resp_cmd("TTL", b"rt%d" % i),
                    {b":%d\r\n" % t for t in range(GEO_RESP_TTL - 2,
                                                   GEO_RESP_TTL + 1)}),
                   (_resp_cmd("INCRBY", b"rc%d" % i, 7), b":7\r\n"),
                   (_resp_cmd("DEL", k), b":1\r\n")]
        n = _resp_exchange(f, kv)
        out["kv_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        lat, lng = geo_points(n_members, seed, GEO_RESP_BOX)
        # the members' coordinates as the proxy parses them
        la = [float("%.7f" % x) for x in lat.tolist()]
        ln = [float("%.7f" % x) for x in lng.tolist()]
        names = [b"m%04d" % i for i in range(n_members)]
        t0 = time.perf_counter()
        adds = []
        for lo in range(0, n_members, 100):
            args = []
            for i in range(lo, min(n_members, lo + 100)):
                args += ["%.7f" % ln[i], "%.7f" % la[i], names[i]]
            adds.append((_resp_cmd("GEOADD", "fleet", *args),
                         b":%d\r\n" % (len(args) // 3)))
        n += _resp_exchange(f, adds)
        out["geoadd_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        geo_cmds, found = [], 0
        for j in range(n_geo):
            c = int(rng.integers(n_members))
            near = sorted((cells.haversine_m(la[c], ln[c], la[i], ln[i]),
                           names[i]) for i in range(n_members))
            want = [m for d, m in near if d <= 1000.0]
            found += len(want)
            geo_cmds.append((_resp_cmd("GEORADIUS", "fleet", "%.7f" % ln[c],
                                       "%.7f" % la[c], 1, "km"),
                             b"*%d\r\n" % len(want)
                             + b"".join(_resp_bulk(m) for m in want)))
            a, b = (int(x) for x in rng.integers(n_members, size=2))
            unit, scale = (("km", 1000.0) if j % 2 else ("m", 1.0))
            d = cells.haversine_m(la[a], ln[a], la[b], ln[b])
            geo_cmds.append((_resp_cmd("GEODIST", "fleet", names[a],
                                       names[b], unit),
                             _resp_bulk(repr(round(d / scale, 4)).encode())))
            geo_cmds.append((_resp_cmd("GEOPOS", "fleet", names[a], "nope"),
                             b"*2\r\n*2\r\n" + _resp_bulk(repr(ln[a]).encode())
                             + _resp_bulk(repr(la[a]).encode())
                             + b"$-1\r\n"))
        n += _resp_exchange(f, geo_cmds, chunk=1)
        out.update(geo_s=time.perf_counter() - t0, commands=n,
                   georadius_members_per_query=found / max(1, n_geo))
    finally:
        sock.close()
        proxy.stop()
    return out


def run_geo(device, work: str, n_points: int = GEO_POINTS,
            n_parts: int = GEO_PARTITIONS, n_moves: int = GEO_MOVES,
            n_adds: int = GEO_ADDS, searches=GEO_SEARCHES,
            n_threads: int = GEO_THREADS, box: float = GEO_BOX,
            resp: dict = None) -> dict:
    """BASELINE config #5, geo range-scan + compact: the two tables of the
    geo client (geo_main, geo_idx), n_parts partitions each, as
    PegasusServers (cuda backend) behind two in-process RpcServers, one
    replica each; n_points points made from the seed with numpy and
    bulk-loaded from GEO_FILES raw sets per partition (RPC_BULK_LOAD_INGEST,
    the merges on the card), each installed run held to the cpu backend
    (check_ingest). Through GeoClient in this process: n_moves points
    deleted and set again at a new place and n_adds added, from
    n_threads threads; the radial searches (searches: radius, count,
    number) from n_threads threads, every answer equal to a brute force
    over the known final points; a manual compaction of every partition
    of both tables (update_app_envs), each output held to the cpu
    backend's compaction of its runs from just before
    (check_compaction); the same searches again; then a RESP session
    through a RedisProxy (run_resp). Merge-kernel launches are counted
    around the ingest and the compaction, fence-lookup launches around
    each round of searches."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pegasus_tpu_torch.base import consts
    from pegasus_tpu_torch.client import PegasusClient, StaticResolver
    from pegasus_tpu_torch.engine.db import EngineOptions
    from pegasus_tpu_torch.engine.replica_service import ReplicaService
    from pegasus_tpu_torch.engine.server_impl import PegasusServer
    from pegasus_tpu_torch.geo import GeoClient
    from pegasus_tpu_torch.ops.fence_lookup import LAUNCHES as FENCE
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES
    from pegasus_tpu_torch.rpc import codec
    from pegasus_tpu_torch.rpc import messages as msg
    from pegasus_tpu_torch.rpc.task_codes import RPC_BULK_LOAD_INGEST
    from pegasus_tpu_torch.rpc.transport import RpcServer
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    on_card = torch.device(device).type == "cuda"
    os.makedirs(work, exist_ok=True)
    out = {"config": "BASELINE #5: geo/ S2-indexed keys (src/geo) "
           "range-scan + compact; tools/geo_bench.py's geography, levels "
           f"{GEO_MIN_LEVEL}/{GEO_MAX_LEVEL}",
           "tables": [a for a, _ in GEO_APPS], "partitions": n_parts,
           "points": n_points, "rows": 2 * n_points, "moves": n_moves,
           "adds": n_adds, "threads": n_threads,
           "geo_idx_options": GEO_IDX_OPTS,
           "searches": [{"radius_m": r, "count": c, "n": n}
                        for r, c, n in searches],
           "guarantee": "every acknowledged geo write read back by "
                        "search; one copy (no mutation log)",
           "reduced": {"replicas": "3 -> 1 (the cluster phase holds "
                                   "replication)",
                       "points": f"raised from geo_bench's 20 000 to "
                                 f"{n_points}, the box from +-0.1 to "
                                 f"+-{box} deg (~54 points per km^2 at "
                                 f"1 000 000 in +-0.7)",
                       "clock": "moves + adds 10 000 + 5 000 -> "
                                f"{n_moves} + {n_adds}, searches a round "
                                "1 100 -> "
                                f"{sum(n for _, _, n in searches)}"}}
    t0 = time.perf_counter()
    lat, lng = geo_points(n_points, 29, box)
    rows = geo_rows(lat, lng)
    provider = os.path.join(work, "provider")
    counts = write_geo_provider(provider, rows, n_parts, GEO_FILES)
    out["fill_s"] = time.perf_counter() - t0

    rpcs, servers, clients, geo = [], {a: [] for a, _ in GEO_APPS}, {}, None
    try:
        addr = {a: {} for a, _ in GEO_APPS}
        for node in range(2):
            svc = ReplicaService()
            rpc = RpcServer().start()
            rpcs.append(rpc)
            for app, app_id in GEO_APPS:
                for p in range(node, n_parts, 2):
                    opts = GEO_IDX_OPTS if app == "geo_idx" else {}
                    srv = PegasusServer(
                        os.path.join(work, f"{app}_{p}"), app_id=app_id,
                        pidx=p, server=f"node{node}",
                        options=EngineOptions(device=device, **opts))
                    svc.add_replica(srv, n_parts)
                    servers[app].append(srv)
                    addr[app][p] = rpc.address
            rpc.register_serverlet(svc)
        for app, app_id in GEO_APPS:
            clients[app] = PegasusClient(StaticResolver(
                app_id, [addr[app][p] for p in range(n_parts)]))

        def ingest(item):
            app, app_id, p = item
            conn = clients[app].pool.get(addr[app][p], shard=p)
            _, body = conn.call(RPC_BULK_LOAD_INGEST, codec.encode(
                msg.BulkLoadIngestRequest(provider, app, n_parts)),
                app_id=app_id, partition_index=p, timeout=SERVE_TIMEOUT_S)
            r = codec.decode(msg.BulkLoadIngestResponse, body)
            if r.error or r.ingested_records != counts[app][p]:
                raise AssertionError(f"{app} partition {p} ingested "
                                     f"{r.ingested_records} of "
                                     f"{counts[app][p]} (error {r.error})")

        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2 * n_parts) as ex:
            list(ex.map(ingest, [(a, i, p) for a, i in GEO_APPS
                                 for p in range(n_parts)]))
        out["ingest_s"] = time.perf_counter() - t0
        out["ingest_merge_launches"] = LAUNCHES["merge_path"]
        out["ingest_check_s"] = sum(
            check_ingest(servers[a], provider, a, n_parts)
            for a, _ in GEO_APPS)
        del rows

        geo = GeoClient(clients["geo_main"], clients["geo_idx"],
                        min_level=GEO_MIN_LEVEL, max_level=GEO_MAX_LEVEL,
                        scan_threads=GEO_THREADS)
        # ---- updates through the client
        rng = np.random.default_rng(41)
        moved = rng.choice(n_points, n_moves, replace=False)
        new_lat, new_lng = geo_points(n_moves + n_adds, 43, box)
        lat = np.concatenate([lat, new_lat[n_moves:]])
        lng = np.concatenate([lng, new_lng[n_moves:]])
        lat[moved], lng[moved] = new_lat[:n_moves], new_lng[:n_moves]
        work_items = ([("move", int(i)) for i in moved.tolist()]
                      + [("add", n_points + j) for j in range(n_adds)])

        def update(items):
            for kind, i in items:
                hk = b"p%07d" % i
                if kind == "move":
                    geo.delete(hk, b"s")
                geo.set_geo_data(float(lat[i]), float(lng[i]), hk, b"s",
                                 b"v%d" % i)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_threads) as ex:
            list(ex.map(update, [work_items[t::n_threads]
                                 for t in range(n_threads)]))
        out["update_s"] = time.perf_counter() - t0
        n_all = n_points + n_adds
        truth = GeoTruth(lat, lng, [geo_value(i, a, b) for i, (a, b) in
                                    enumerate(zip(lat.tolist(),
                                                  lng.tolist()))],
                         [b"p%07d" % i for i in range(n_all)])

        qrng = np.random.default_rng(47)
        queries = []
        for radius, count, n in searches:
            half = GEO_QUERY_BOX * box
            qlat, qlng = (GEO_CENTER[0] + qrng.uniform(-half, half, n),
                          GEO_CENTER[1] + qrng.uniform(-half, half, n))
            queries += [(float(a), float(b), radius, count)
                        for a, b in zip(qlat, qlng)]

        def search_round(what):
            FENCE["fence_lookup"] = 0
            with COMPACT_TRACER.session() as sess:
                t0 = time.perf_counter()
                res = _geo_searches(geo, truth, queries, n_threads)
                res["seconds"] = time.perf_counter() - t0
            rng_calls = sess.summary().get("read.range", {})
            res.update(fence_launches=FENCE["fence_lookup"],
                       device_range_calls=rng_calls.get("calls", 0),
                       device_range_queries=rng_calls.get("records", 0))
            if not res["device_range_calls"] or (
                    on_card and not res["fence_launches"]):
                raise AssertionError(f"geo searches {what}: "
                                     f"{res['device_range_calls']} device "
                                     f"range calls, "
                                     f"{res['fence_launches']} fence "
                                     f"launches")
            return res

        out["search_before_compaction"] = search_round("before compaction")

        # ---- manual compaction of every partition of both tables
        every = [s for a, _ in GEO_APPS for s in servers[a]]
        kept = keep_runs(every, os.path.join(work, "pre_compaction"))
        # a full compaction, as geo_bench's manual_compact: bottommost, so
        # the moves' tombstones go (check_compaction's cpu merge is too)
        trigger = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY:
                   str(int(time.time()) - 1),
                   consts.MANUAL_COMPACT_ONCE_KEY_PREFIX
                   + consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_KEY:
                   consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_FORCE}
        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        t0 = time.perf_counter()
        for srv in every:
            srv.update_app_envs(trigger)
        if on_card:
            torch.cuda.synchronize(device)
        compact_s = time.perf_counter() - t0
        states = [srv.manual_compact_service.query_compact_state()
                  for srv in every]
        if any(not st.startswith("idle; last finish") for st in states):
            raise AssertionError(f"a geo compaction did not finish: "
                                 f"{states}")
        out["compaction"] = {"seconds": compact_s,
                             "merge_launches": LAUNCHES["merge_path"],
                             "check_s": check_compaction(every, kept)}
        if on_card and LAUNCHES["merge_path"] < len(every):
            raise AssertionError(f"the geo compaction launched "
                                 f"{LAUNCHES['merge_path']} merges for "
                                 f"{len(every)} partitions")
        shutil.rmtree(os.path.join(work, "pre_compaction"))
        for srv in every:
            srv.engine.wait_primes()
        out["search_after_compaction"] = search_round("after compaction")
        out["resp"] = run_resp(geo, clients["geo_main"], **(resp or {}))
        if on_card:
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                device)
    finally:
        if geo is not None:
            geo.close()
        for c in clients.values():
            c.close()
        for r in rpcs:
            r.stop()
        for srvs in servers.values():
            for srv in srvs:
                srv.close()
    return out


# ------------------------------------------------------------- cluster

CLUSTER_OPS = 40_000
CLUSTER_THREADS = 8
CLUSTER_SAMPLE = 25_000       # untouched loaded keys read back (100 000
                              # until the levels phase, 50 000 until geo
                              # and the heal leg)
CLUSTER_KILL_AT = 15_000
CLUSTER_RESTART_AT = 25_000
CLUSTER_APP = "usertable"
CLUSTER_RESTORED = "usertable_r"
CLUSTER_OP_DEADLINE_S = 180.0  # one op's retries, a failover included
SCHED_URGENT_PER_NODE = 4      # the scheduler leg's urgent cap per node
SCHED_TTL_S = 300.0            # its first tick's lease, over the rounds
SCHED_ROUNDS = 8               # its flush rounds at most
SCHED_TRIGGER = 4              # the replicas' L0 trigger (EngineOptions)
CLUSTER_SPLIT_THREADS = 2      # YCSB-A writers while the split runs
CLUSTER_SPLIT_MARGIN_S = 2.0   # writers' time before and after the split
CLUSTER_DDL_TIMEOUT_S = 1800.0  # one shell DDL over every partition
CLUSTER_POLL_S = 900.0         # a session or a restore followed to its end
CLUSTER_CHECK_S = 900.0        # compactions and audits followed to their end
CLUSTER_COLLECT_S = 1.0        # the collector's round (onebox: 10 s)
CLUSTER_DETECT_S = 0.5         # its canary's probe (onebox: 2 s)
HOT_ROWS = 256                 # the residency leg's rows under one hash key
HOT_DEADLINE_S = 60.0          # its verdict, pin, primes and calm, each


def _free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def cluster_ini(work: str, device, fd: dict = None) -> tuple:
    """onebox.ini cut to one meta, replica1..3 and the collector on fixed
    free ports (replica1's http_port too), data under `work`,
    compaction_backend = cuda (`device = cpu` when the phase rehearses on
    the CPU), [failure_detector] as onebox.ini's unless `fd` overrides
    it. The collector's round every CLUSTER_COLLECT_S and its canary's
    probe every CLUSTER_DETECT_S; its canary table is onebox's `test`
    (8 partitions x 3), and the scheduler stays off (the scheduler leg
    runs its ticks in this process). Left out: the offload service, and
    the toollets (a middleware sends every frame per frame, and the
    read-backs are measured batched). -> (ini path, meta address,
    {replica name: address}, {"collector": address, "http_port": n,
    "collector_http_port": n})."""
    import configparser

    import torch

    cp = configparser.ConfigParser()
    cp.read(os.path.join(ROOT, "onebox.ini"))
    for sec in ("core", "apps.compact_offload", "apps.meta2", "apps.meta3"):
        cp.remove_section(sec)
    ports = _free_ports(7)
    cp["apps.meta1"]["port"] = str(ports[0])
    cp["apps.meta1"]["state_dir"] = os.path.join(work, "meta")
    meta = f"127.0.0.1:{ports[0]}"
    nodes = {}
    for i in (1, 2, 3):
        sec = cp[f"apps.replica{i}"]
        sec["port"] = str(ports[i])
        sec["data_dir"] = os.path.join(work, f"replica{i}")
        nodes[f"replica{i}"] = f"127.0.0.1:{ports[i]}"
    cp["apps.replica1"]["http_port"] = str(ports[4])
    coll = cp["apps.collector"]
    coll["port"] = str(ports[5])
    coll["interval_seconds"] = str(CLUSTER_COLLECT_S)
    coll["detect_interval_seconds"] = str(CLUSTER_DETECT_S)
    coll["http_port"] = str(ports[6])
    extra = {"collector": f"127.0.0.1:{ports[5]}", "http_port": ports[4],
             "collector_http_port": ports[6]}
    cp["pegasus.server"]["meta_servers"] = meta
    cp["pegasus.server"]["compaction_backend"] = "cuda"
    if torch.device(device).type != "cuda":
        cp["pegasus.server"]["device"] = "cpu"
    for k, v in (fd or {}).items():
        cp["failure_detector"][k] = str(v)
    path = os.path.join(work, "cluster.ini")
    with open(path, "w") as f:
        cp.write(f)
    return path, meta, nodes, extra


class _App:
    """One `python -m pegasus_tpu_torch.server --app <name>` process, its
    output in <work>/<name>.<n>.log, `env` added to this process's."""

    def __init__(self, ini: str, name: str, work: str, env: dict = None):
        self.ini, self.name, self.work = ini, name, work
        self.env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
        self.starts = 0
        self.proc = None
        self.start()

    def start(self):
        self.starts += 1
        self.log = os.path.join(self.work, f"{self.name}.{self.starts}.log")
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "pegasus_tpu_torch.server", "--config",
                 self.ini, "--app", self.name], stdout=out,
                stderr=subprocess.STDOUT, cwd=self.work, env=self.env)

    def wait_started(self, deadline: float) -> str:
        marker = f"[pegasus-tpu] app {self.name} started "
        while True:
            with open(self.log) as f:
                for line in f:
                    if line.startswith(marker):
                        return line.split()[-1]
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name} exited "
                                     f"{self.proc.returncode}: {self.tail()}")
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name} did not start")
            time.sleep(0.1)

    def tail(self) -> str:
        with open(self.log) as f:
            return f.read()[-3000:]

    def alive(self) -> bool:
        return self.proc.poll() is None


def _meta_call(meta: str, code: str, req, resp_cls, timeout: float = 60):
    from pegasus_tpu_torch.rpc import codec
    from pegasus_tpu_torch.rpc.transport import RpcConnection

    host, _, port = meta.rpartition(":")
    conn = RpcConnection((host, int(port)))
    try:
        _, body = conn.call(code, codec.encode(req), timeout=timeout)
        return codec.decode(resp_cls, body)
    finally:
        conn.close()


def _config(meta: str, app: str):
    from pegasus_tpu_torch.meta import messages as mm
    from pegasus_tpu_torch.meta.meta_server import RPC_CM_QUERY_CONFIG

    return _meta_call(meta, RPC_CM_QUERY_CONFIG, mm.QueryConfigRequest(app),
                      mm.QueryConfigResponse)


def _shell(meta: str, line: str) -> str:
    """One command through the port's Shell.run_line, its meta and node
    calls allowed CLUSTER_DDL_TIMEOUT_S. The shell prints an error where
    a command fails (`ERROR: ...`, `... failed: ...`, a usage line): any
    such line raises here. -> the command's output."""
    import io
    import re

    from pegasus_tpu_torch.shell.main import Shell

    out = io.StringIO()
    sh = Shell([meta], out=out, rpc_timeout=CLUSTER_DDL_TIMEOUT_S)
    try:
        sh.run_line(line)
    finally:
        sh.pool.close()
    text = out.getvalue()
    if sh.failed or re.search(r"^(ERROR|usage:|unknown command)|failed",
                              text, re.M):
        raise AssertionError(f"shell `{line}`: {text.strip()[:2000]}")
    return text


def _shell_poll(meta: str, line: str, done: str) -> tuple:
    """A status command through the shell until its output holds `done`
    (a failed status raises in _shell). -> (output, seconds)."""
    t0 = time.perf_counter()
    while True:
        text = _shell(meta, line)
        if done in text:
            return text, time.perf_counter() - t0
        if time.perf_counter() - t0 > CLUSTER_POLL_S:
            raise AssertionError(f"`{line}` never read {done!r}: {text}")
        time.sleep(0.2)


def _kernel_counts(addrs) -> dict:
    """{addr: {counter: value}} scraped with perf-counters-by-prefix."""
    return {a: json.loads(_remote_command(a, "perf-counters-by-prefix",
                                          ["kernel."]))
            for a in addrs}


def _delta(after: dict, before: dict, name: str) -> dict:
    return {a: after[a].get(name, 0) - before.get(a, {}).get(name, 0)
            for a in after}


def _compute_apps() -> list:
    """[(pid, used device MiB)] of every process on the card, from
    nvidia-smi --query-compute-apps (its pids are the host's, which a
    container's need not match)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [(int(pid), float(mib)) for pid, mib in
            (map(str.strip, line.split(","))
             for line in out.strip().splitlines())]


def _cluster_client_init(progress) -> None:
    global _PROGRESS
    _PROGRESS = progress


def split_value(tid: int, seq: int) -> bytes:
    """A value a split-time writer issues, unique per (thread, op)."""
    return b"S%02d%017d" % (tid, seq) + _FILLER


class _SplitWriters:
    """YCSB-A updates while a split runs: n_threads closed-loop writers
    over MetaResolver on zipfian ranks (each thread its own, rank mod
    n_threads), every update retried until it is acknowledged: a parent
    rejects its children's keys from split phase 1 and a child serves
    once seeded, so a write waits out its child's seeding (up to
    CLUSTER_DDL_TIMEOUT_S, the split's own bound). Keeps every
    acknowledged value, the latencies and the retries."""

    def __init__(self, meta: str, n_records: int, n_threads: int):
        import threading

        from pegasus_tpu_torch.client import MetaResolver

        self.resolver = MetaResolver([meta], CLUSTER_APP)
        self.zipf = ZipfRanks(n_records)
        self.n = n_threads
        self.stop = threading.Event()
        self.acked, self.lat, self.errors = {}, [], []
        self.retries = 0
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._worker, args=(t,))
                        for t in range(n_threads)]

    def start(self) -> "_SplitWriters":
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def _worker(self, tid: int) -> None:
        from pegasus_tpu_torch.client import PegasusClient

        rng = np.random.default_rng(5000 + tid)
        c = PegasusClient(self.resolver)
        lat, acked, seq = [], {}, 0
        try:
            while not self.stop.is_set():
                r = self.zipf.pick(rng)
                while r % self.n != tid:
                    r = self.zipf.pick(rng)
                val = split_value(tid, seq)
                seq += 1
                t = time.perf_counter()
                end = time.monotonic() + CLUSTER_DDL_TIMEOUT_S
                while True:
                    try:
                        c.set(hash_key(r), SERVE_FIELD, val)
                        break
                    except Exception:  # noqa: BLE001 - re-routed, retried
                        if time.monotonic() > end:
                            raise
                        with self._lock:
                            self.retries += 1
                        time.sleep(0.05)
                lat.append(time.perf_counter() - t)
                acked[r] = val
        except Exception as e:  # raised by finish()
            self.errors.append(e)
        finally:
            c.close()
            with self._lock:
                self.lat.extend(lat)
                self.acked.update(acked)

    def finish(self) -> dict:
        self.stop.set()
        for t in self.threads:
            t.join(timeout=CLUSTER_DDL_TIMEOUT_S + 60)
        secs = time.perf_counter() - self.t0
        if self.errors or any(t.is_alive() for t in self.threads):
            raise AssertionError(f"split-time writers failed: "
                                 f"{self.errors[:3]}")
        return {"seconds": secs, "ops": len(self.lat),
                "ops_per_s": len(self.lat) / secs,
                "set": _percentiles(self.lat), "retries": self.retries,
                "keys_written": len(self.acked)}


def _learns(addrs, app_id: int, first_pidx: int) -> list:
    """[(pidx, node, seconds)] of every finished learn of partitions
    >= first_pidx of the app, from each process's event ring."""
    out = []
    for a in addrs:
        dump = json.loads(_remote_command(a, "events-dump",
                                          ["4096", "learn.finish"]))
        for evs in dump.values():
            for ev in evs:
                at = ev.get("attrs") or {}
                aid, _, p = str(at.get("gpid", "")).partition(".")
                if aid == str(app_id) and int(p) >= first_pidx:
                    if not at.get("ok"):
                        raise AssertionError(f"learn of {at['gpid']} on "
                                             f"{a} failed")
                    out.append((int(p), a, float(at["dur_s"])))
    return out


def _owned_rows(blocks, pidx: int, pmask: int) -> tuple:
    """(rows whose key hashes to pidx under pmask, rows that do not), the
    hash recomputed from the key bytes (crc64 of the hash key)."""
    from pegasus_tpu_torch.engine.block import _batch_key_hashes

    own = other = 0
    for b in blocks:
        h = _batch_key_hashes(b.key_arena, b.key_off, b.key_len)
        hit = int(np.count_nonzero((h & np.uint64(pmask)) == np.uint64(pidx)))
        own += hit
        other += b.n - hit
    return own, other


def _snapshot_runs(work: str, names: dict, app_id: int, replicas,
                   snap: str) -> dict:
    """Hard links of each (node, pidx) replica's SSTs just before a
    compaction. -> {(node, pidx): [paths]}."""
    kept = {}
    for node, p in replicas:
        path = os.path.join(work, names[node], f"{app_id}.{p}", "data")
        d = os.path.join(snap, f"{names[node]}.{p}")
        os.makedirs(d)
        kept[(node, p)] = []
        for f in engine_files(path):
            dst = os.path.join(d, os.path.basename(f))
            os.link(f, dst)
            kept[(node, p)].append(dst)
    return kept


def _check_outputs(work: str, names: dict, app_id: int, kept: dict,
                   pmask: int) -> dict:
    """Each compacted replica's output held to the cpu backend's
    compaction of its runs (`kept`: {(node, pidx): the run files},
    compact_blocks with the same pidx and partition_mask); replicas given
    the same files (a restored table's, the backup's) share one cpu
    compaction. With a mask, every output key owned by its partition.
    -> {"seconds", "input_rows", "output_records", "gc_dropped_rows",
    "records_by_pidx"} (by pidx: the records of the last replica
    checked)."""
    import threading

    from pegasus_tpu_torch.engine.sstable import read_sst
    from pegasus_tpu_torch.ops.compact import CompactOptions, compact_blocks

    t0 = time.perf_counter()
    wants, locks, guard = {}, {}, threading.Lock()

    def want_of(p, files):
        """-> (cpu compaction digest, input rows, output rows, rows not
        owned), once per (pidx, files)."""
        key = (p, tuple(files))
        with guard:
            lock = locks.setdefault(key, threading.Lock())
        with lock:
            if key not in wants:
                runs = [read_sst(f)[0] for f in files]
                want = compact_blocks(runs, CompactOptions(
                    backend="cpu", prefix_u32=8, pidx=p,
                    partition_mask=pmask, bottommost=True, default_ttl=0,
                    runs_sorted=True)).block
                wants[key] = (block_digest([want]), sum(r.n for r in runs),
                              want.n,
                              _owned_rows(runs, p, pmask)[1] if pmask else 0)
            return wants[key]

    def one(item):
        (node, p), files = item
        want, n_in, n_out, dropped = want_of(p, files)
        got = engine_blocks(os.path.join(work, names[node], f"{app_id}.{p}",
                                          "data"))
        if block_digest(got) != want:
            raise AssertionError(f"{names[node]} partition {p}: compaction "
                                 f"{block_digest(got)} != cpu backend {want}")
        if pmask and _owned_rows(got, p, pmask)[1]:
            raise AssertionError(f"{names[node]} partition {p} kept keys "
                                 f"it does not own under mask {pmask}")
        return p, n_in, n_out, dropped

    res = _parallel(one, sorted(kept.items(), key=lambda kv: kv[0][1]))
    return {"seconds": time.perf_counter() - t0,
            "input_rows": sum(r[1] for r in res),
            "output_records": sum(r[2] for r in res),
            "gc_dropped_rows": sum(r[3] for r in res),
            "records_by_pidx": {p: n for p, _, n, _ in res}}


# ------------------------------------------ the runtime planes of a cluster

TRACE_SLEEP_MS = 300     # the sleep armed on one secondary's plog group


def _shell_nodes(meta: str, line: str) -> dict:
    """A shell command that answers node by node ("[host:port]", then
    that node's reply) -> {address: reply text}."""
    import re

    out, cur = {}, None
    for ln in _shell(meta, line).splitlines():
        m = re.fullmatch(r"\[(\d+\.\d+\.\d+\.\d+:\d+)\]", ln.strip())
        if m:
            cur = m.group(1)
            out[cur] = ""
        elif cur is not None:
            out[cur] += ln + "\n"
    return out


def _traced_put(client, hk: bytes) -> dict:
    """One set through `client` in a fresh request trace -> this
    process's view of the trace."""
    from pegasus_tpu_torch.runtime.tracing import REQUEST_TRACER

    before = {t["trace_id"] for t in REQUEST_TRACER.trace(512)}
    client.set(hk, SERVE_FIELD, b"traced")
    new = [t for t in REQUEST_TRACER.trace(512)
           if t["trace_id"] not in before and t["op"] == "RPC_RRDB_RRDB_PUT"]
    if len(new) != 1:
        raise AssertionError(f"one set made {len(new)} traces")
    return new[0]


def check_traces(meta: str, addrs: list, app: str, n_parts: int) -> dict:
    """Request tracing through the port's shell. A traced set from this
    process: `request_trace` on every node shows its spans under the
    set's trace_id (the primary's handler and the two secondaries'
    prepares). Then `set_fail_point` arms a one-shot sleep on one
    secondary's plog group commit, and that node's `slow_requests`
    holds the next traced set, the sleep in its plog.append span."""
    from pegasus_tpu_torch.client import MetaResolver, PegasusClient

    client = PegasusClient(MetaResolver([meta], app), timeout=60)
    try:
        t = _traced_put(client, b"traced-put")
        views = {}
        for a in addrs:
            for tr in json.loads(_shell(meta, f"request_trace {a} 64")):
                if tr["trace_id"] == t["trace_id"]:
                    views[a] = sorted({s["name"] for s in tr["spans"]})
        names = set().union(*views.values()) if views else set()
        missing = {"replica.prepare", "replica.on_prepare", "plog.append",
                   "engine.apply", "engine.write"} - names
        if set(views) != set(addrs) or missing:
            raise AssertionError(f"trace {t['trace_id']} on {sorted(views)}"
                                 f" of {addrs}, missing {missing}: {views}")
        hk = b"slow-put"
        pidx = int(_partition_of(np.frombuffer(hk, np.uint8)[None],
                                 np.array([len(hk)]), n_parts)[0])
        node = _config(meta, app).partitions[pidx].secondaries[0]
        armed = _shell(meta, f"set_fail_point {node} plog.group "
                             f"1*sleep({TRACE_SLEEP_MS})")
        slow = _traced_put(client, hk)
    finally:
        client.close()
    # the whole ledger (its 256 entries): the canary's and the
    # collector's traced ops on a loaded box can push the slow put past
    # the last 64 within a second
    ledger = [tr for tr in json.loads(_shell(meta,
                                             f"slow_requests {node} 256"))
              if tr["trace_id"] == slow["trace_id"]]
    if not ledger:
        raise AssertionError(f"{node}'s slow_requests lacks trace "
                             f"{slow['trace_id']}")
    held = [s for s in ledger[0]["spans"]
            if s["duration_us"] >= 0.8 * TRACE_SLEEP_MS * 1000]
    stage = max(held, key=lambda s: s["depth"])["name"] if held else None
    if stage != "plog.append":
        raise AssertionError(f"the slow ledger names {stage}: {ledger[0]}")
    return {"keys_written": 2,
            "trace_id": t["trace_id"], "client_us": t["duration_us"],
            "spans_by_node": views, "fail_point": armed.strip(),
            "slow_trace_us": ledger[0]["duration_us"], "slow_stage": stage,
            "slow_stage_us": max(s["duration_us"] for s in held)}


def check_tables(meta: str, app: str, acked_ops: int) -> dict:
    """`tables`: the nodes' ledgers folded; the table's reads and writes
    cover every acknowledged op, its device reads and resident bytes are
    counted."""
    folded = json.loads(_shell(meta, "tables 5"))
    t = folded["tables"].get(app, {})
    if t.get("read_qps", 0) + t.get("write_qps", 0) < acked_ops or \
            t.get("device_read_count", 0) <= 0 or \
            t.get("hbm_resident_bytes", 0) <= 0:
        raise AssertionError(f"tables folded {t} for {acked_ops} "
                             f"acknowledged ops")
    return {k: t[k] for k in ("read_qps", "write_qps", "scan_qps",
                              "bytes_in", "bytes_out", "errors",
                              "device_read_count", "hbm_resident_bytes",
                              "device_seconds")} | {"top": folded["top"]}


def check_compaction_planes(meta: str, addrs: list) -> dict:
    """After a manual compaction on every node: `compact_trace` shows
    the device stages, `device_health` reads not wedged with a last_ok
    from this run, and `job_trace` holds a manual "compact" job with its
    engine.merge hops."""
    stages, jobs = {}, {}
    for a in addrs:
        text = _shell(meta, f"compact_trace {a} 400")
        stages[a] = sorted({ln.split()[1] for ln in text.splitlines()
                            if ln[:1].isdigit()})
        if "device" not in stages[a]:
            raise AssertionError(f"{a}'s compact_trace: {text[-2000:]}")
        recs = [r for rs in json.loads(_shell(meta, f"job_trace {a} 50"))
                .values() for r in rs if r["kind"] == "compact"
                and r["attrs"].get("trigger") == "manual"]
        if not recs or not any(h["name"] == "engine.merge"
                               for r in recs for h in r["hops"]):
            raise AssertionError(f"{a}'s job_trace holds no manual compact "
                                 f"job with a merge hop")
        jobs[a] = len(recs)
    health = {a: json.loads(t) for a, t in
              _shell_nodes(meta, "device_health").items()}
    for a, h in health.items():
        if h["wedged_at_stage"] is not None or h["last_ok"] is None or \
                time.time() - h["last_ok"] > CLUSTER_CHECK_S:
            raise AssertionError(f"{a}'s device_health: {h}")
    if set(health) != set(addrs):
        raise AssertionError(f"device_health answered {sorted(health)}")
    return {"compact_trace_stages": stages, "manual_compact_jobs": jobs,
            "device_health": {a: {"device": h["device"],
                                  "last_ok_age_s": time.time() - h["last_ok"]}
                              for a, h in health.items()}}


def check_node_compaction_jobs(meta: str, addrs: list, calls: dict) -> dict:
    """`job_trace` on every node: its batched "compact" job's
    engine.merge hops carry as many kernel launches as the node's
    counters moved by in the node compaction."""
    out = {}
    for a in addrs:
        recs = [r for rs in json.loads(_shell(meta, f"job_trace {a} 50"))
                .values() for r in rs if r["kind"] == "compact"
                and r["attrs"].get("trigger") == "batched"]
        if not recs:
            raise AssertionError(f"{a}'s job_trace holds no batched job")
        hops = recs[-1]["hops"]
        launches = sum(h.get("launches", 0) for h in hops
                       if h["name"] == "engine.merge")
        if launches != calls[a]:
            raise AssertionError(f"{a}: the job's merge hops launched "
                                 f"{launches}, the counters moved by "
                                 f"{calls[a]}: {hops}")
        out[a] = {"merge_hops": sum(h["name"] == "engine.merge"
                                    for h in hops),
                  "install_hops": sum(h["name"] == "engine.install"
                                      for h in hops),
                  "launches": launches,
                  "merge_s": sum(h["duration_us"] for h in hops
                                 if h["name"] == "engine.merge") / 1e6}
    return out


def _caller(meta: str):
    from pegasus_tpu_torch.collector.cluster_doctor import ClusterCaller

    return ClusterCaller([meta], timeout=CLUSTER_CHECK_S)


def check_doctor_down(meta: str, victim: str) -> dict:
    """The port's cluster doctor while `victim` is dead and failed over,
    before it restarts: a verdict other than healthy, a cause naming the
    victim's address."""
    from pegasus_tpu_torch.collector.cluster_doctor import run_cluster_doctor

    t0 = time.perf_counter()
    caller = _caller(meta)
    try:
        v = run_cluster_doctor([meta], slow_last=0, caller=caller)
    finally:
        caller.close()
    causes = [c["cause"] for c in v["causes"]]
    if v["verdict"] == "healthy" or not any(victim in c for c in causes):
        raise AssertionError(f"doctor with {victim} down: {v['verdict']}, "
                             f"{causes[:8]}")
    return {"seconds": time.perf_counter() - t0, "verdict": v["verdict"],
            "dead": v["evidence"]["nodes"]["dead"], "causes": len(causes),
            "first_causes": causes[:4]}


def check_doctor_healthy(meta: str, app_id: int, parts: int) -> dict:
    """After full redundancy and the audit: the port's doctor names no
    dead node, no unserved or under-replicated partition and no audit
    mismatch, and its beacon-folded audit evidence covers every
    partition of the table (polled until the beacons carry the audit);
    the shell's cluster_doctor prints the same verdict line."""
    from pegasus_tpu_torch.collector.cluster_doctor import run_cluster_doctor

    t0 = time.perf_counter()
    want = {f"{app_id}.{p}" for p in range(parts)}
    caller = _caller(meta)
    try:
        while True:
            v = run_cluster_doctor([meta], slow_last=0, caller=caller)
            ev = v["evidence"]
            bad = (ev["nodes"]["dead"] or ev["partitions"]["unserved"]
                   or ev["partitions"]["under_replicated"]
                   or ev["audit"]["mismatches"])
            if bad:
                raise AssertionError(f"doctor after the audit: {v}")
            if want <= set(ev["audit"]["checked"]):
                break
            if time.perf_counter() - t0 > CLUSTER_CHECK_S:
                raise AssertionError(f"the doctor's audit evidence never "
                                     f"covered {sorted(want)}: {ev['audit']}")
            time.sleep(0.5)
    finally:
        caller.close()
    line = f"cluster verdict: {v['verdict'].upper()}" + (
        f" ({len(v['causes'])} cause(s))" if v["causes"] else "")
    shown = _shell(meta, "cluster_doctor 0").strip().splitlines()[-1]
    if shown != line:
        raise AssertionError(f"shell cluster_doctor printed {shown!r}, "
                             f"the doctor {line!r}")
    return {"seconds": time.perf_counter() - t0, "verdict": v["verdict"],
            "causes": [c["cause"] for c in v["causes"]][:8],
            "audit_checked": len(set(ev["audit"]["checked"]) & want),
            "shell": shown}


def _sched_status(node: str, gpid: str) -> dict:
    return json.loads(_remote_command(node, "compact-sched-status",
                                      [gpid]))[gpid]


class _RatePoller:
    """Rate counters of nodes, each read every 50 ms by a thread of its
    own while the context is open, keeping the largest value seen. A
    read rolls a counter's window once it is a second old and
    republishes the finished window's rate until the next roll, by any
    reader: the collector's scrapes roll the same windows every round,
    so only a reader that never pauses a second sees every window."""

    def __init__(self, probes):
        import threading

        self.best = {p: 0.0 for p in probes}   # (node, counter) -> max
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._poll, args=(p,),
                                          daemon=True) for p in probes]

    def _poll(self, probe):
        node, name = probe
        while not self._stop.is_set():
            v = json.loads(_remote_command(node, "perf-counters-by-prefix",
                                           [name])).get(name, 0)
            self.best[probe] = max(self.best[probe], v)
            self._stop.wait(0.05)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)

    def wait(self, node: str, name: str, deadline_s: float = 10.0) -> float:
        """The largest rate seen, waited for until it shows events."""
        end = time.monotonic() + deadline_s
        while self.best[(node, name)] <= 0:
            if time.monotonic() > end:
                raise AssertionError(f"{node}: {name} shows no event")
            time.sleep(0.05)
        return self.best[(node, name)]


def _trigger_jobs(node: str, job_ids: set) -> dict:
    """{trigger: [compact jobs]} among `node`'s traced compactions whose
    id a scheduler tick minted."""
    out = {}
    for rs in json.loads(_remote_command(node, "job-trace",
                                         ["1000"])).values():
        for r in rs:
            if r["kind"] != "compact" or r["job_id"] not in job_ids:
                continue
            for h in r["hops"]:
                if h["name"] == "engine.trigger":
                    out.setdefault(h.get("trigger"), []).append(r)
    return out


def check_scheduler(meta: str, addrs: list, names: dict, app_id: int,
                    markers: dict, client, on_card: bool) -> dict:
    """The compaction scheduler's leg, run in this process as the
    collector role would (run_scheduler_tick), on a table whose replicas
    hold their ingested run and the run's flushes in L0:

      1. a tick with knobs urgent_l0 1 and SCHED_URGENT_PER_NODE urgent
         tokens per node, partition 0 named hot: partition 0 deferred on
         its primary only (its secondaries `normal`, defer_primary_only),
         the partitions with the most debt urgent, delivered to every
         node with no error; the shell's `compact_sched all` shows each
         node's delivered tokens;
      2. flush rounds (a marker write to each target partition, then
         flush-memtable of those partitions on every node) until every
         urgent replica compacted at trigger // 2 (its L0 empty; its
         node's urgent_count and merge-kernel launches rose; its job
         carries the tick's id) and the hot primary holds its L0 at the
         trigger (deferred_count rose);
      3. a second tick without the hot set lifts the defer: the next
         flush compacts that primary.

    The marker writes rewrite existing keys, so the table's records do
    not change. On the card every node's merge-kernel launches rise.
    -> the leg's record."""
    from pegasus_tpu_torch.collector.compact_scheduler import \
        run_scheduler_tick

    t_leg = time.perf_counter()
    hot = f"{app_id}.0"
    before = _kernel_counts(addrs)
    knobs = {"urgent_l0": 1, "max_urgent_per_node": SCHED_URGENT_PER_NODE,
             "ttl_s": SCHED_TTL_S, "max_device": 0}
    caller = _caller(meta)
    try:
        t0 = time.perf_counter()
        rep = run_scheduler_tick([meta], hot_gpids=[hot], knobs=knobs,
                                 caller=caller)
        tick_s = time.perf_counter() - t0
        dec, got = rep["decisions"], rep["delivered"]
        if rep["errors"] or set(got) != set(addrs):
            raise AssertionError(f"scheduler tick: errors {rep['errors']}, "
                                 f"delivered to {sorted(got)}")
        prim = dec[hot]["node"]
        urgent = {a: sorted(g for g, pol in got[a].items()
                            if pol == "urgent") for a in addrs}
        if dec[hot]["policy"] != "defer" or got[prim][hot] != "defer" or \
                any(got[a][hot] != "normal" for a in addrs if a != prim) \
                or not all(urgent.values()):
            raise AssertionError(f"scheduler decisions: hot {dec[hot]}, "
                                 f"delivered {got}")
        shown = {}
        node = None
        for ln in _shell(meta, "compact_sched all").splitlines():
            if ln.startswith("["):
                node = ln.strip("[]")
            elif ln.startswith("  ") and ":" in ln:
                gpid, rest = ln.strip().split(":", 1)
                shown.setdefault(node, {})[gpid] = rest.split()[0]
        for a in addrs:
            if any(shown.get(a, {}).get(g) != pol
                   for g, pol in got[a].items()):
                raise AssertionError(f"compact_sched on {a}: "
                                     f"{shown.get(a)} != {got[a]}")
        job_ids = {d["job"] for d in dec.values()}

        pending = {(a, g) for a in addrs for g in urgent[a]}
        rounds, urgent_rate, hot_l0 = 0, {}, 0
        urgent_c = "engine.compact.sched.urgent_count"
        deferred_c = "engine.compact.sched.deferred_count"
        # the collector's scrapes roll the same rate windows: read them
        # all the while
        with _RatePoller([(a, urgent_c) for a in addrs]
                         + [(prim, deferred_c)]) as rates:
            while pending or hot_l0 < SCHED_TRIGGER:
                if rounds == SCHED_ROUNDS:
                    raise AssertionError(
                        f"after {rounds} flush rounds: urgent replicas not "
                        f"compacted {pending}, hot primary L0 {hot_l0}")
                targets = sorted({g for _, g in pending} | {hot})
                for g in targets:
                    client.set(markers[int(g.split(".")[1])], b"m", b"1")
                _parallel(lambda a: _remote_command(
                    a, "flush-memtable", targets,
                    timeout=CLUSTER_CHECK_S), addrs)
                rounds += 1
                done = {(a, g) for a, g in pending
                        if _sched_status(a, g)["l0_files"] == 0}
                for a in {a for a, _ in done}:
                    urgent_rate[names[a]] = rates.wait(a, urgent_c)
                pending -= done
                hot_l0 = _sched_status(prim, hot)["l0_files"]
            deferred_rate = rates.wait(prim, deferred_c)
        if _sched_status(prim, hot)["policy"] != "defer":
            raise AssertionError("the hot primary lost its defer token")
        held_s = time.perf_counter() - t_leg

        # the defer lifted: a tick without the hot set, then a flush
        rep2 = run_scheduler_tick([meta], knobs=dict(
            knobs, urgent_l0=SCHED_TRIGGER, ttl_s=30.0), caller=caller)
        if rep2["errors"] or rep2["delivered"][prim].get(hot) == "defer":
            raise AssertionError(f"second tick: {rep2['errors']}, "
                                 f"{rep2['delivered'].get(prim, {})}")
        client.set(markers[0], b"m", b"1")
        _parallel(lambda a: _remote_command(
            a, "flush-memtable", [hot], timeout=CLUSTER_CHECK_S), addrs)
        lifted = _sched_status(prim, hot)
        if lifted["l0_files"] != 0:
            raise AssertionError(f"the lifted primary did not compact: "
                                 f"{lifted}")
        job_ids |= {d["job"] for d in rep2["decisions"].values()}
    finally:
        caller.close()
    after = _kernel_counts(addrs)
    launches = _delta(after, before, "kernel.merge_path.launches")
    jobs = {a: _trigger_jobs(a, job_ids) for a in addrs}
    for a in addrs:
        n = len(jobs[a].get("urgent", []))
        if n < len(urgent[a]):
            raise AssertionError(f"{a}: {n} urgent compactions carry the "
                                 f"tick's ids, {len(urgent[a])} were due")
        if on_card and launches[a] <= 0:
            raise AssertionError(f"{a}: the urgent compactions launched no "
                                 f"merge kernel")
    policies = {}
    for d in dec.values():
        policies[d["policy"]] = policies.get(d["policy"], 0) + 1
    return {"seconds": time.perf_counter() - t_leg, "tick_s": tick_s,
            "held_s": held_s, "rounds": rounds, "hot": hot,
            "hot_primary": names[prim], "hot_l0_held": hot_l0,
            "decisions": policies,
            "urgent_tokens": {names[a]: len(urgent[a]) for a in addrs},
            "urgent_jobs": {names[a]: {t: len(v) for t, v in jobs[a].items()}
                            for a in addrs},
            "urgent_rate": urgent_rate, "deferred_rate": deferred_rate,
            "merge_launches": {names[a]: v for a, v in launches.items()},
            "urgent_merge_launches": {
                names[a]: sum(h.get("launches", 0)
                              for r in jobs[a].get("urgent", [])
                              for h in r["hops"]
                              if h["name"] == "engine.merge")
                for a in addrs},
            "lift": {"policy": rep2["delivered"][prim][hot],
                     "l0_after": lifted["l0_files"]}}


def _await(what: str, fn, deadline_s: float = HOT_DEADLINE_S,
           poll_s: float = 0.2):
    """fn() polled until it returns something true. -> (it, seconds)."""
    t0 = time.perf_counter()
    while True:
        got = fn()
        if got:
            return got, time.perf_counter() - t0
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"{what} within {deadline_s} s")
        time.sleep(poll_s)


def check_residency(meta: str, coll: str, pool, progress, addrs: list,
                    on_card: bool) -> dict:
    """The collector's closed hotkey loop pins a partition's runs on the
    card, and the fence-lookup kernel serves its reads:

      1. HOT_ROWS rows written under one new hash key of a partition the
         loop does not pin now, flushed into a run on each of its
         replicas (flush-memtable <gpid>), acknowledged;
      2. the client process reads them back in one batch, again and
         again, every answer the acknowledged value, until: the
         collector flags the partition, finds the hot key by
         detect_hotkey on the primary (its verdict must be that hash key,
         kind read) and sends set-read-residency on (its
         collector.app.<t>.hotkey.<p>.device_resident gauge reads 1 only
         after the primary's reply); then every SST of the primary's node
         is resident on the card (engine.hbm.resident_ssts equals the
         replica-disk file count) and engine.hbm.resident_bytes grew;
      3. the hot reads launched the fence-lookup kernel on the primary
         (kernel.fence_lookup.launches before and after);
      4. reads of the other partitions calm it: the loop sends
         set-read-residency off (the gauge back to 0)."""
    t_leg = time.perf_counter()
    cfg = _config(meta, CLUSTER_APP)
    app_id, n_parts = cfg.app.app_id, cfg.app.partition_count
    pfx = f"collector.app.{CLUSTER_APP}.hotkey."

    def gauges():
        return json.loads(_remote_command(coll, "perf-counters-by-prefix",
                                          [pfx]))

    def hbm(addr):
        return json.loads(_remote_command(addr, "perf-counters-by-prefix",
                                          ["engine.hbm."]))

    g0 = gauges()
    pinned0 = sorted(p for p in range(n_parts)
                     if g0.get(f"{pfx}{p}.device_resident") == 1)
    i = 0
    while True:
        hk = b"hot-residency-%d" % i
        pidx = int(_partition_of(np.frombuffer(hk, np.uint8)[None],
                                 np.array([len(hk)]), n_parts)[0])
        if pidx not in pinned0:
            break
        i += 1
    pc = cfg.partitions[pidx]
    prim, gpid = pc.primary, f"{app_id}.{pidx}"
    hbm0 = hbm(prim)
    rows = pool.apply(_client_hot_write, (hk, HOT_ROWS))
    for a in [prim] + list(pc.secondaries):
        _remote_command(a, "flush-memtable", [gpid], timeout=CLUSTER_CHECK_S)
    before = _kernel_counts(addrs)
    progress.value = 0
    hammer = pool.apply_async(_client_hammer, (4 * HOT_DEADLINE_S,))
    try:
        def verdict():
            if hammer.ready():
                hammer.get()          # a wrong answer raises here
            info = json.loads(_remote_command(coll, "collector-info"))
            return info["hotkeys"].get(CLUSTER_APP, {}).get(str(pidx))

        found, verdict_s = _await("the collector's verdict", verdict)
        if found["key"] != repr(hk) or found["kind"] != "read":
            raise AssertionError(f"verdict {found}, hammered {hk!r}")
        _, pin_s = _await("set-read-residency on", lambda: gauges().get(
            f"{pfx}{pidx}.device_resident") == 1)

        def all_resident():
            files = sum(r["sst_files"] for r in json.loads(
                _remote_command(prim, "replica-disk")).values())
            h = hbm(prim)
            return (h, files) if h.get("engine.hbm.resident_ssts") == files \
                else None

        (hbm1, files), resident_s = _await("every run resident",
                                           all_resident)
    finally:
        progress.value = -1
        hot = hammer.get(timeout=CLUSTER_CHECK_S)
        progress.value = 0
    after = _kernel_counts(addrs)
    fence = _delta(after, before, "kernel.fence_lookup.launches")
    if on_card and fence[prim] <= 0:
        raise AssertionError(f"the hot reads launched no fence kernel on "
                             f"the primary: {fence}")
    if hbm1["engine.hbm.resident_bytes"] <= \
            hbm0.get("engine.hbm.resident_bytes", 0):
        raise AssertionError(f"resident bytes {hbm0} -> {hbm1}")
    calm = pool.apply_async(_client_calm, (pidx, 4 * HOT_DEADLINE_S))
    try:
        _, calm_s = _await("set-read-residency off", lambda: (
            calm.get() if calm.ready() else True) and gauges().get(
            f"{pfx}{pidx}.device_resident") == 0)
    finally:
        progress.value = -1
        calmed = calm.get(timeout=CLUSTER_CHECK_S)
        progress.value = 0
    return {"seconds": time.perf_counter() - t_leg, "partition": pidx,
            "pinned_before": pinned0, "hash_key": hk.decode(), "rows": rows,
            "verdict": found["key"], "verdict_s": verdict_s,
            "pin_s": pin_s, "resident_s": resident_s, "calm_s": calm_s,
            "primary": prim, "primary_ssts": files,
            "resident_bytes": [hbm0.get("engine.hbm.resident_bytes", 0),
                               hbm1["engine.hbm.resident_bytes"]],
            "resident_ssts": hbm1["engine.hbm.resident_ssts"],
            "budget_bytes": hbm1["engine.hbm.budget_bytes"],
            "hot_reads": hot, "calming_reads": calmed,
            "fence_launches": fence}


def check_collector(meta: str, coll: str, http_port: int,
                    availability: dict) -> dict:
    """The collector's other surfaces: its canary's samples (before the
    kill, after the restart, now), GET /metrics on replica1's http_port
    listing engine.hbm.resident_bytes, the shell's `slo <collector>`,
    `app_stat` and `slow_requests --cluster` answering through it, and
    its own doctor's verdict."""
    import urllib.request

    t0 = time.perf_counter()
    info = json.loads(_remote_command(coll, "collector-info"))
    availability = dict(availability, end=info["availability"])
    if any(a["samples"] <= 0 for a in availability.values()):
        raise AssertionError(f"the canary took no samples: {availability}")
    with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/metrics",
                                timeout=60) as r:
        metrics = r.read().decode()
    if "\nengine_hbm_resident_bytes " not in metrics:
        raise AssertionError("/metrics lists no engine.hbm.resident_bytes")
    slo = json.loads(_shell(meta, f"slo {coll}"))
    verdicts = next(iter(slo.values()))
    if CLUSTER_APP not in verdicts:
        raise AssertionError(f"slo named no {CLUSTER_APP}: {slo}")
    stat = _shell(meta, "app_stat").strip().splitlines()
    row = next((ln.split() for ln in stat[1:]
                if ln.split()[0] == CLUSTER_APP), None)
    if row is None:
        raise AssertionError(f"app_stat: {stat}")
    slow = json.loads(_shell(meta, "slow_requests --cluster 5"))
    doctor = json.loads(_remote_command(coll, "cluster-doctor", ["0"],
                                        timeout=CLUSTER_CHECK_S))
    return {"seconds": time.perf_counter() - t0,
            "availability": availability,
            "metrics_lines": metrics.count("\n"),
            "slo": {t: {k: v[k] for k in ("verdict", "fast_burn",
                                          "slow_burn", "requests_fast",
                                          "errors_fast")}
                    for t, v in verdicts.items()},
            "app_stat": dict(zip(stat[0].split()[1:], map(float, row[1:]))),
            "slow_requests": len(slow),
            "hotspots": info["hotspots"], "hotkeys": info["hotkeys"],
            "doctor": {"verdict": doctor["verdict"],
                       "causes": [c["cause"] for c in doctor["causes"]][:8]}}


HEAL_APP = "heal"
HEAL_PARTITIONS = 4
HEAL_ROWS = 5_000        # 20 000, cut for the clock
HEAL_SORT_KEYS = 100     # rows under one hash key (one multi_set each)
HEAL_DEADLINE_S = 180.0  # a verdict, a re-seed or the primes, each
# the collector's flight recorder: the window its captures pull and look
# for a first cause in, and the cooldown between two captures (onebox:
# 120 s and 30 s; the leg's two drills are seconds apart)
HEAL_INCIDENT_WINDOW_S = 20
HEAL_INCIDENT_COOLDOWN_S = 2


def _flip_tail(path: str, nbytes: int = 8) -> None:
    """Flip the last nbytes of a file (tests/test_integrity.py's
    flip_tail): the header still parses, the last section's crc fails."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - nbytes)
        tail = f.read(nbytes)
        f.seek(size - nbytes)
        f.write(bytes(b ^ 0xFF for b in tail))


def _hbm(addr: str) -> dict:
    return json.loads(_remote_command(addr, "perf-counters-by-prefix",
                                      ["engine.hbm."]))


def _coll_doctor(coll: str) -> dict:
    return json.loads(_remote_command(coll, "cluster-doctor", ["0"],
                                      timeout=CLUSTER_CHECK_S))


def _members_of(meta: str, app: str, pidx: int) -> list:
    pc = _config(meta, app).partitions[pidx]
    return [pc.primary] + list(pc.secondaries) if pc.primary else []


def _hosts(addr: str, gpid: str) -> bool:
    return gpid in json.loads(_remote_command(addr, "replica-disk"))


def _await_reseed(meta: str, victim: str, app_id: int, pidx: int) -> float:
    """Until the meta re-seeded the quarantined replica: the partition
    has 3 members, each hosting it, and the victim's quarantine record
    is acknowledged. -> seconds waited."""
    gpid = f"{app_id}.{pidx}"

    def done():
        members = _members_of(meta, HEAL_APP, pidx)
        return (len(members) == 3 and all(_hosts(a, gpid) for a in members)
                and gpid not in json.loads(_remote_command(
                    victim, "quarantine-status")))

    t0 = time.perf_counter()
    _await(f"the re-seed of {gpid} on {victim}", done, HEAL_DEADLINE_S)
    return time.perf_counter() - t0


def _await_primes(addr: str, want_ssts: int) -> dict:
    """Until addr's node holds at least want_ssts runs on the device (an
    async prime lands after its flush or learn). -> its engine.hbm.*."""
    _await(f"{addr}'s primes", lambda: _hbm(addr).get(
        "engine.hbm.resident_ssts", 0) >= want_ssts, HEAL_DEADLINE_S)
    return _hbm(addr)


def _heal_audit(meta: str, app_id: int) -> dict:
    """The audit of the heal table alone, retried until every partition
    is conclusive (a re-seeded member may still apply its backlog: the
    equal-decree rule reads that as pending, never a mismatch)."""
    from pegasus_tpu_torch.collector.cluster_doctor import run_cluster_audit

    t0 = time.perf_counter()
    for _ in range(30):
        caller = _caller(meta)
        try:
            report = run_cluster_audit([meta], apps=[HEAL_APP],
                                       wait_s=CLUSTER_CHECK_S, caller=caller)
        finally:
            caller.close()
        if report["mismatches"]:
            raise AssertionError(f"heal audit: {report['mismatches']}")
        if len(report["ok"]) == HEAL_PARTITIONS:
            return {"seconds": time.perf_counter() - t0,
                    "replicas": sum(len(d) for d in
                                    report["digests"].values())}
        time.sleep(0.5)
    raise AssertionError(f"heal audit never conclusive: {report}")


def _heal_read_back(meta: str, addrs: list, app_id: int, rows: dict) -> dict:
    """Every row read from each of the 3 replicas of its partition
    (member k of every partition through a StaticResolver, batch_get in
    waves), each the acknowledged value; fence launches scraped from the
    nodes around it."""
    from pegasus_tpu_torch.client import PegasusClient, StaticResolver

    keys = list(rows)
    before = _kernel_counts(addrs)
    t0 = time.perf_counter()
    members = [_members_of(meta, HEAL_APP, p) for p in range(HEAL_PARTITIONS)]
    for k in range(3):
        cli = PegasusClient(StaticResolver(app_id, [
            (m[k].rpartition(":")[0], int(m[k].rpartition(":")[2]))
            for m in members]), timeout=120)
        try:
            for lo in range(0, len(keys), 2000):
                got = cli.batch_get(keys[lo:lo + 2000])
                bad = [(key, g) for key, g in zip(keys[lo:lo + 2000], got)
                       if g != rows[key]]
                if bad:
                    raise AssertionError(f"replica {k} of the heal table "
                                         f"read {len(bad)} rows wrong: "
                                         f"{bad[:3]}")
        finally:
            cli.close()
    after = _kernel_counts(addrs)
    return {"seconds": time.perf_counter() - t0, "rows": len(keys),
            "replicas": 3, "fence_launches": _delta(
                after, before, "kernel.fence_lookup.launches")}


def _quiet_causes(nodes: list, window: float) -> float:
    """Wait until no node's event ring holds a first-cause-class event
    inside the last `window` seconds, so that an arm made now is the
    earliest one an incident window can see. -> seconds waited."""
    from pegasus_tpu_torch.collector.flight_recorder import FIRST_CAUSE_NAMES

    t0 = time.perf_counter()
    while True:
        latest = 0.0
        for a in nodes:
            for evs in json.loads(_remote_command(
                    a, "events-dump", ["1000"])).values():
                latest = max([latest] + [e["ts"] for e in evs
                                         if e["name"] in FIRST_CAUSE_NAMES])
        wait = latest + window + 0.5 - time.time()
        if wait <= 0:
            return time.perf_counter() - t0
        time.sleep(min(wait, window))


def check_heal(meta: str, coll: str, coll_http: int, addrs: list,
               names: dict, work: str, incident_dir: str,
               n_rows: int = HEAL_ROWS, on_card: bool = True) -> dict:
    """The integrity loop on the cluster, a table `heal` of
    HEAL_PARTITIONS partitions x 3 replicas, n_rows rows written through
    the client and flushed on every replica (flush-memtable).

    Scrub drill: with the meta frozen (set_meta_level freezed: no
    re-seed yet), the last 8 bytes of the newest SST of partition 0's
    first secondary flipped; the shell's scrub_replica answers
    quarantined with a crc finding, quarantine_status names the gpid
    with source scrub, that node's engine.hbm.resident_bytes falls (the
    closed engine released its runs), and the collector's doctor answers
    degraded naming the quarantine. The meta's level restored, its FD
    tick re-seeds the replica; the node's resident bytes come back, the
    audit of the table is conclusive and mismatch-free, and every row
    reads back with its acknowledged value from each of the 3 replicas.

    Auto-heal drill (the collector under PEGASUS_AUTOHEAL=1): the
    collector's doctor healthy, `audit.digest` armed on partition 1's
    first secondary through set-fail-point, the audit finds that one
    mismatch, the collector's doctor answers critical with autoheal
    naming that replica and an incident id; GET /incidents on the
    collector lists the incident, its first cause the fail point's arm
    on audit.digest, and the shell's flight_recorder lists it; the fail
    point disarmed, the re-seed lands, the re-audit is conclusive and
    the read-back whole."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from pegasus_tpu_torch.client import MetaResolver, PegasusClient
    from pegasus_tpu_torch.collector.cluster_doctor import run_cluster_audit

    t_leg = time.perf_counter()
    out = {"partitions": HEAL_PARTITIONS, "rows": n_rows}
    _shell(meta, f"create {HEAL_APP} -p {HEAL_PARTITIONS} -r 3")
    cfg = _config(meta, HEAL_APP)
    app_id = cfg.app.app_id
    if any(not pc.primary or len(pc.secondaries) != 2
           for pc in cfg.partitions):
        raise AssertionError(f"heal partitions without 3 members: {cfg}")
    client = PegasusClient(MetaResolver([meta], HEAL_APP), timeout=120)
    rows = {}
    try:
        def write(j):
            hk = b"heal%05d" % j
            kvs = {b"s%03d" % k: b"hv%d.%d" % (j, k) for k in range(
                min(per_hk, n_rows - j * per_hk))}
            client.multi_set(hk, kvs)
            return hk, kvs

        # at least 8 hash keys a partition, so a small table fills each
        per_hk = min(HEAL_SORT_KEYS, -(-n_rows // (8 * HEAL_PARTITIONS)))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            for hk, kvs in ex.map(write, range(-(-n_rows // per_hk))):
                rows.update({(hk, sk): v for sk, v in kvs.items()})
        out["write_s"] = time.perf_counter() - t0
    finally:
        client.close()
    gpids = [f"{app_id}.{p}" for p in range(HEAL_PARTITIONS)]
    ssts0 = {a: _hbm(a).get("engine.hbm.resident_ssts", 0) for a in addrs}
    for a in addrs:
        _remote_command(a, "flush-memtable", gpids, timeout=300)
    # every node hosts a replica of each partition: each flushed run
    # primes on the card asynchronously
    for a in addrs:
        disk = json.loads(_remote_command(a, "replica-disk"))
        _await_primes(a, ssts0[a] + sum(disk[g]["sst_files"] for g in gpids))

    # ---- scrub drill
    level = _shell(meta, "get_meta_level").split()[-1]
    victim = cfg.partitions[0].secondaries[0]
    gpid = f"{app_id}.0"
    data = os.path.join(work, names[victim], gpid, "data")
    newest = max((os.path.join(data, f) for f in os.listdir(data)
                  if f.endswith(".sst")), key=os.path.getmtime)
    hbm0 = _hbm(victim)
    _shell(meta, "set_meta_level freezed")
    scrub = {"victim": victim, "gpid": gpid, "file": os.path.basename(newest)}
    try:
        t0 = time.perf_counter()
        _flip_tail(newest)
        text = _shell(meta, f"scrub_replica {victim} {gpid}")
        ans = json.loads(text.split("\n", 1)[1])[gpid]
        scrub["flip_to_quarantine_s"] = time.perf_counter() - t0
        if ans.get("quarantined") is not True or not any(
                "crc32 mismatch" in f["detail"] for f in ans["findings"]):
            raise AssertionError(f"scrub_replica: {ans}")
        scrub["finding"] = ans["findings"][0]["detail"]
        status = json.loads(_shell(meta, f"quarantine_status {victim}"))
        if status.get(gpid, {}).get("source") != "scrub" or not status[
                gpid].get("dir"):
            raise AssertionError(f"quarantine_status: {status}")
        hbm1 = _hbm(victim)
        fell = (hbm0["engine.hbm.resident_bytes"]
                - hbm1["engine.hbm.resident_bytes"])
        scrub["resident_bytes_fell"] = fell
        if fell <= 0:
            raise AssertionError(f"{victim}'s resident bytes did not fall: "
                                 f"{hbm0} -> {hbm1}")
        cause = f"replica {gpid} on node {victim} quarantined (scrub: "

        def degraded():
            v = _coll_doctor(coll)
            scrub["doctor"] = {"verdict": v["verdict"], "causes": [
                c["cause"] for c in v["causes"]][:6],
                "incident": v.get("incident")}
            return v["verdict"] == "degraded" and any(
                c["cause"].startswith(cause) for c in v["causes"])

        _await("the collector's doctor naming the quarantine", degraded,
               HEAL_DEADLINE_S)
    finally:
        _shell(meta, f"set_meta_level {level}")
    scrub["reseed_s"] = _await_reseed(meta, victim, app_id, 0)
    hbm2 = _await_primes(victim, hbm1["engine.hbm.resident_ssts"] + 1)
    scrub["resident_bytes"] = [hbm0["engine.hbm.resident_bytes"],
                               hbm1["engine.hbm.resident_bytes"],
                               hbm2["engine.hbm.resident_bytes"]]
    scrub["audit"] = _heal_audit(meta, app_id)
    scrub["read_back"] = _heal_read_back(meta, addrs, app_id, rows)
    if on_card and not sum(scrub["read_back"]["fence_launches"].values()):
        raise AssertionError("the heal read-back launched no fence kernel")
    out["scrub"] = scrub

    # ---- auto-heal drill
    auto = {}
    t0 = time.perf_counter()
    _await("the collector's doctor healthy",
           lambda: _coll_doctor(coll)["verdict"] == "healthy",
           HEAL_DEADLINE_S)
    auto["healthy_s"] = time.perf_counter() - t0
    victim = cfg.partitions[1].secondaries[0]
    gpid = f"{app_id}.1"
    auto.update(victim=victim, gpid=gpid, quiet_s=_quiet_causes(
        addrs + [coll], HEAL_INCIDENT_WINDOW_S))
    _remote_command(victim, "set-fail-point",
                    ["audit.digest", f"return({victim}@{gpid})"])
    try:
        caller = _caller(meta)
        try:
            report = run_cluster_audit([meta], apps=[HEAL_APP],
                                       wait_s=CLUSTER_CHECK_S, caller=caller)
        finally:
            caller.close()
        if [(m["gpid"], m["node"]) for m in report["mismatches"]] != \
                [(gpid, victim)]:
            raise AssertionError(f"the planted audit: "
                                 f"{report['mismatches']}")
        t0 = time.perf_counter()
        verdicts = []

        def unhealthy():
            verdicts.append(_coll_doctor(coll))
            return verdicts[-1]["verdict"] != "healthy"

        _await("the collector's doctor seeing the mismatch", unhealthy,
               HEAL_DEADLINE_S)
        v = verdicts[-1]
        auto["doctor"] = {"verdict": v["verdict"],
                          "autoheal": v.get("autoheal"),
                          "incident": v.get("incident"),
                          "seconds": time.perf_counter() - t0}
        if v["verdict"] != "critical" or v.get("autoheal") != [
                {"gpid": gpid, "node": victim}] or not v.get("incident"):
            raise AssertionError(f"the collector's doctor: {v['verdict']}, "
                                 f"autoheal {v.get('autoheal')}, incident "
                                 f"{v.get('incident')}, causes "
                                 f"{[c['cause'] for c in v['causes']][:4]}")
        inc_id = v["incident"]
        base = f"http://127.0.0.1:{coll_http}/incidents"
        with urllib.request.urlopen(base, timeout=60) as r:
            listed = json.loads(r.read())["incidents"]
        with urllib.request.urlopen(f"{base}?id={inc_id}", timeout=60) as r:
            inc = json.loads(r.read())["incident"]
        entry = next((i for i in listed if i["id"] == inc_id), None)
        fc = inc["first_cause"] or {}
        if entry is None or entry["first_cause"] != "failpoint.arm" or \
                fc.get("attrs", {}).get("point") != "audit.digest":
            raise AssertionError(f"/incidents: {entry}, first cause {fc}")
        auto["incident"] = {"id": inc_id, "first_cause": fc["name"],
                            "point": fc["attrs"]["point"],
                            "node": fc.get("node"),
                            "timeline_events": len(inc["timeline"]),
                            "listed": len(listed)}
        # the shell's flight_recorder reads the collector's artifacts
        saved = os.environ.get("PEGASUS_INCIDENT_DIR")
        os.environ["PEGASUS_INCIDENT_DIR"] = incident_dir
        try:
            shown = _shell(meta, "flight_recorder")
        finally:
            if saved is None:
                os.environ.pop("PEGASUS_INCIDENT_DIR", None)
            else:
                os.environ["PEGASUS_INCIDENT_DIR"] = saved
        if f"{inc_id}  trigger=doctor first_cause=failpoint.arm" not in shown:
            raise AssertionError(f"flight_recorder: {shown[:1000]}")
    finally:
        _remote_command(victim, "set-fail-point", ["audit.digest", "off()"])
    auto["reseed_s"] = _await_reseed(meta, victim, app_id, 1)
    auto["audit"] = _heal_audit(meta, app_id)
    auto["read_back"] = _heal_read_back(meta, addrs, app_id, rows)
    if on_card and not sum(auto["read_back"]["fence_launches"].values()):
        raise AssertionError("the heal read-back launched no fence kernel")
    out["autoheal"] = auto
    out["seconds"] = time.perf_counter() - t_leg
    return out


def check_lockrank(path: str, graphs: dict) -> dict:
    """The cluster's processes ran with PEGASUS_LOCKRANK=1 and appended
    any lock-order violation to `path`: none may be there. `graphs`
    holds each replica node's lockrank.* counters, read while it ran:
    every node must show an acquisition graph (edges > 0, the detector
    armed and recording) and no violation of its own."""
    lines = []
    if os.path.exists(path):
        with open(path) as f:
            lines = [ln for ln in f if ln.strip()]
    if lines:
        raise AssertionError(f"lock-order violations: {lines[:5]}")
    edges = {n: g.get("lockrank.edges", 0) for n, g in graphs.items()}
    if not graphs or min(edges.values()) <= 0:
        raise AssertionError(f"lock-order detector not armed: {graphs}")
    found = {n: g.get("lockrank.violations", 0) for n, g in graphs.items()}
    if any(found.values()):
        raise AssertionError(f"lock-order violations: {found}")
    return {"violations": 0, "edges": edges}


def run_cluster(device, work: str, provider: str, counts: list,
                n_records: int = SERVE_RECORDS,
                n_parts: int = SERVE_PARTITIONS, n_ops: int = CLUSTER_OPS,
                n_threads: int = CLUSTER_THREADS,
                n_sample: int = CLUSTER_SAMPLE,
                kill_at: int = CLUSTER_KILL_AT,
                restart_at: int = CLUSTER_RESTART_AT,
                fd: dict = None, lifecycle: bool = False,
                heal: bool = False, heal_rows: int = HEAL_ROWS) -> dict:
    """BASELINE config #3 with its three replicas, as a cluster of
    processes: one meta and replica1..3 (cluster_ini), each `python -m
    pegasus_tpu_torch.server` on the card. Through the port's shell:
    `create usertable -p n_parts -r 3`, then a bulk-load session
    (`start_bulk_load usertable <provider> -a`, followed with
    query_bulk_load_status to succeed): the meta walks the partitions,
    each primary ingests through PacificA (3 merge launches per replica);
    one marker write per partition carries the secondaries' ingests;
    every replica's run held to the cpu backend (ingest_want). The YCSB-A
    run from a client process, the node that leads the most partitions
    SIGKILLed at op kill_at and restarted after the meta failed it over
    and at op restart_at (the meta re-adds it; it relearns), the port's
    cluster doctor naming it between the two (check_doctor_down); every
    acknowledged update and a sample of untouched keys read back with
    batch_get. Then the compaction scheduler's leg (check_scheduler):
    ticks in this process whose tokens make urgent replicas compact on
    the card and hold the hot primary's L0 until a second tick lifts it.

    With `lifecycle`, then: a cold backup (`backup_app`); the split to
    2 * n_parts partitions (RPC_CM_START_PARTITION_SPLIT) while
    CLUSTER_SPLIT_THREADS writers keep updating, every acknowledged
    write kept. Then (after the split, or else right after the
    read-back) a manual compaction of every replica through
    RPC_CM_SET_APP_ENVS, each primary's output held to the cpu backend
    with the table's ownership mask (after a split: only owned keys
    survive, and the primaries' records sum to the table's); with
    `lifecycle`, the read-back again through the doubled partitions;
    the consistency audit (run_cluster_audit: trigger-audit on every
    primary, query-audit on every replica): equal digests at an equal
    decree; then the doctor names no dead node, no under-replicated
    partition and no mismatch, its audit evidence covering every
    partition, and the shell prints its verdict (check_doctor_healthy).
    With `heal`, then the integrity loop (check_heal): a scrub drill on
    a table `heal` (a flipped SST quarantined, the node's device bytes
    released, the doctor degraded, the meta's re-seed, every row read
    back from 3 replicas) and an auto-heal drill (a planted audit
    mismatch, the collector's doctor critical and auto-healing it, its
    incident served on /incidents with the fail point's arm as first
    cause). With `lifecycle`, last: the backup
    restored into usertable_r (`restore_app`, followed with
    query_restore_status to ok), the read-back keys read from it with
    their values at backup time, and `batched-manual-compact <app_id>` on
    every node (the batched merge kernel), each replica's output held to
    the cpu backend. Kernel launches are scraped from each process
    (perf-counters-by-prefix kernel.)."""
    import multiprocessing
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pegasus_tpu_torch.base import consts
    from pegasus_tpu_torch.client import MetaResolver, PegasusClient
    from pegasus_tpu_torch.collector.cluster_doctor import run_cluster_audit
    from pegasus_tpu_torch.meta import messages as mm
    from pegasus_tpu_torch.meta.meta_server import (RPC_CM_LIST_NODES,
                                                    RPC_CM_SET_APP_ENVS,
                                                    RPC_CM_SPLIT_APP)

    on_card = torch.device(device).type == "cuda"
    os.makedirs(work, exist_ok=True)
    ini, meta, node_addr, extra = cluster_ini(work, device, fd)
    coll = extra["collector"]
    names = {a: n for n, a in node_addr.items()}
    addrs = list(node_addr.values())
    out = {"config": "BASELINE #3: YCSB workload-A (50/50 read/update), "
           f"{n_parts} hash partitions, 3 replicas",
           "processes": "meta1 + replica1..3, one python -m "
                        "pegasus_tpu_torch.server each",
           "partitions": n_parts, "records": n_records, "ops": n_ops,
           "threads": n_threads, "zipf_theta": SERVE_THETA,
           "guarantee": "every acknowledged write on a quorum (2 of 3) "
                        "and, after the relearn, on all 3 replicas",
           "reduced": {"fields": "YCSB core fieldcount 10 -> 1 "
                       "(field0, fieldlength 100), as tools/ycsb_bench.py"}}
    apps, pool, loader = {}, None, None
    lock_graphs = {}
    # incident artifacts: the collector's (it auto-heals under
    # PEGASUS_AUTOHEAL=1), and this process's own doctor runs'
    incidents = os.path.join(work, "incidents")
    coll_env = {"PEGASUS_AUTOHEAL": "1",
                "PEGASUS_INCIDENT_DIR": os.path.join(incidents, "collector"),
                "PEGASUS_INCIDENT_WINDOW_S": str(HEAL_INCIDENT_WINDOW_S),
                "PEGASUS_INCIDENT_COOLDOWN_S": str(HEAL_INCIDENT_COOLDOWN_S)}
    saved_dir = os.environ.get("PEGASUS_INCIDENT_DIR")
    os.environ["PEGASUS_INCIDENT_DIR"] = os.path.join(incidents, "local")
    # every process checks its lock order; a violation lands in the file
    lock_file = os.path.join(work, "lockrank.jsonl")
    lock_env = {"PEGASUS_LOCKRANK": "1", "PEGASUS_LOCKRANK_FILE": lock_file}
    t0 = time.perf_counter()
    started = time.perf_counter()

    def step(what):
        print(f"[cluster] {time.perf_counter() - started:.1f} s: {what}",
              flush=True)

    def wait_compacted(app_id, n_replicas, t0):
        """Every replica of the app idle with a finished manual compaction."""
        while True:
            states = [line for a in addrs for line in _remote_command(
                a, "query-compact-state").splitlines()
                if line.startswith(f"{app_id}.")]
            if len(states) == n_replicas and all(
                    "idle; last finish" in st for st in states):
                return
            if time.perf_counter() - t0 > CLUSTER_CHECK_S:
                raise AssertionError(f"compactions did not finish: {states}")
            time.sleep(0.2)

    try:
        deadline = time.monotonic() + 300
        for name in ["meta1"] + list(node_addr):
            apps[name] = _App(ini, name, work, env=lock_env)
        for name, app in apps.items():
            app.wait_started(deadline)
        while True:
            r = _meta_call(meta, RPC_CM_LIST_NODES, mm.ListNodesRequest(),
                           mm.ListNodesResponse)
            if sum(n.alive for n in r.nodes) == 3:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"nodes never beaconed: {r.nodes}")
            time.sleep(0.2)
        # the collector once every node is alive: its canary table gets
        # its 3 replicas
        apps["collector"] = _App(ini, "collector", work,
                                 env=dict(lock_env, **coll_env))
        apps["collector"].wait_started(deadline)
        out["boot_s"] = time.perf_counter() - t0
        step("booted")

        t0 = time.perf_counter()
        _shell(meta, f"create {CLUSTER_APP} -p {n_parts} -r 3")
        cfg = _config(meta, CLUSTER_APP)
        app_id = cfg.app.app_id
        if cfg.app.partition_count != n_parts or any(
                not pc.primary or len(pc.secondaries) != 2
                for pc in cfg.partitions):
            raise AssertionError(f"partitions without 3 members: {cfg}")
        out["create_s"] = time.perf_counter() - t0

        # ---- load: a bulk-load session, the meta walking the partitions
        before = _kernel_counts(addrs)
        t0 = time.perf_counter()
        _shell(meta, f"start_bulk_load {CLUSTER_APP} {provider} -a")
        status, _ = _shell_poll(meta, f"query_bulk_load_status {CLUSTER_APP}",
                                ": succeed,")
        if f"{n_parts}/{n_parts} partitions, {sum(counts)} records" \
                not in status:
            raise AssertionError(f"bulk load session: {status}")
        session_s = time.perf_counter() - t0
        step("bulk-load session succeeded")
        resolver = MetaResolver([meta], CLUSTER_APP)
        # a marker's prepare waits on its secondaries' ingests
        loader = PegasusClient(resolver, timeout=120)
        # one set per partition carries the ingest's commit point to the
        # secondaries, which ingest inside that prepare; a few at a time,
        # so each process ingests a few partitions at once and answers
        # within the prepare's 10 s timeout
        markers, i = {}, 0
        while len(markers) < n_parts:
            hk = b"cluster-marker-%d" % i
            i += 1
            markers.setdefault(int(_partition_of(
                np.frombuffer(hk, np.uint8)[None], np.array([len(hk)]),
                n_parts)[0]), hk)

        def mark(hk):
            end = time.monotonic() + 300
            while True:
                try:
                    return loader.set(hk, b"m", b"1")
                except Exception:  # noqa: BLE001 - a slow secondary
                    if time.monotonic() > end:
                        raise
                    time.sleep(0.5)

        with ThreadPoolExecutor(4) as ex:
            list(ex.map(mark, markers.values()))
        markers_s = time.perf_counter() - t0 - session_s
        step("markers acknowledged")
        while True:
            applied = {}
            for a in addrs:
                for g, ent in json.loads(
                        _remote_command(a, "query-audit", timeout=300)).items():
                    if g.startswith(f"{app_id}."):   # not the canary's
                        applied[(a, g)] = ent["applied"]
            if len(applied) == 3 * n_parts and min(applied.values()) >= 1:
                break
            if time.monotonic() > deadline + 600:
                raise AssertionError(f"secondaries never ingested: "
                                     f"{applied}")
            time.sleep(0.2)
        after = _kernel_counts(addrs)
        load_launches = _delta(after, before, "kernel.merge_path.launches")
        out["load"] = {"seconds": time.perf_counter() - t0,
                       "session_s": session_s, "markers_s": markers_s,
                       "session": status.strip(),
                       "merge_launches": load_launches,
                       "ingested_records": sum(counts)}
        if on_card and sum(load_launches.values()) != \
                3 * n_parts * (SERVE_FILES - 1):
            raise AssertionError(f"load merge launches {load_launches}, "
                                 f"want {3 * n_parts * (SERVE_FILES - 1)}")
        t0 = time.perf_counter()

        def check_one(item):
            name, p = item
            path = os.path.join(work, name, f"{app_id}.{p}", "data")
            want = ingest_want(provider, CLUSTER_APP, n_parts, p, 8, 2)
            got = block_digest(engine_blocks(path))
            if got != want:
                raise AssertionError(f"{name} partition {p}: ingested run "
                                     f"{got} != cpu backend {want}")

        _parallel(check_one, [(n, p) for n in node_addr
                              for p in range(n_parts)])
        out["load"]["check_s"] = time.perf_counter() - t0
        step("ingest checked")

        # ---- the run, a kill and a restart inside it
        ctx = multiprocessing.get_context("spawn")
        progress = ctx.Value("q", 0)
        pool = ctx.Pool(1, initializer=_cluster_client_init,
                        initargs=(progress,))
        res = pool.apply_async(_client_run, (
            None, n_records, n_ops, n_threads, n_sample,
            (meta, CLUSTER_APP)))
        victim = t_kill = t_restart = t_full = None
        led = []
        mem_before_kill = None
        canary = {}
        while not res.ready():
            for name, app in apps.items():
                if not app.alive() and not (name == victim
                                            and t_restart is None):
                    raise AssertionError(f"{name} exited "
                                         f"{app.proc.returncode}: "
                                         f"{app.tail()}")
            n_done = progress.value
            if victim is None and n_done >= kill_at:
                cfg = _config(meta, CLUSTER_APP)
                lead = {}
                for pc in cfg.partitions:
                    lead.setdefault(pc.primary, []).append(pc.pidx)
                vaddr = max(lead, key=lambda a: len(lead[a]))
                victim, led = names[vaddr], lead[vaddr]
                if on_card:
                    mem_before_kill = _compute_apps()
                apps[victim].proc.send_signal(signal.SIGKILL)
                apps[victim].proc.wait()
                t_kill = time.time()
                canary["at_kill"] = json.loads(_remote_command(
                    coll, "collector-info"))["availability"]
            elif t_kill is not None and t_restart is None and \
                    n_done >= restart_at:
                cfg = _config(meta, CLUSTER_APP)
                if all(node_addr[victim] not in [pc.primary] + pc.secondaries
                       for pc in cfg.partitions):
                    t_failed_over = time.time()
                    out["doctor_down"] = check_doctor_down(meta,
                                                           node_addr[victim])
                    apps[victim].start()
                    apps[victim].wait_started(time.monotonic() + 300)
                    t_restart = time.time()
                    canary["after_restart"] = json.loads(_remote_command(
                        coll, "collector-info"))["availability"]
            elif t_restart is not None and t_full is None:
                cfg = _config(meta, CLUSTER_APP)
                if all(len(pc.secondaries) == 2 for pc in cfg.partitions):
                    t_full = time.time()
            time.sleep(0.05)
        run = res.get()
        step("run done")
        if victim is None or t_restart is None:
            raise AssertionError(f"the run ended at op {progress.value} "
                                 f"before the kill and the restart")
        while t_full is None:
            cfg = _config(meta, CLUSTER_APP)
            if all(len(pc.secondaries) == 2 for pc in cfg.partitions):
                t_full = time.time()
            elif time.time() - t_restart > 600:
                raise AssertionError(f"3 replicas never restored: {cfg}")
            time.sleep(0.2)
        sets = run.pop("sets")
        ranks = np.array([r for r, _, _ in sets], np.int64)
        part = _partition_of(*ycsb_hash_keys(ranks), n_parts)
        after_kill = [ack - t_kill for (r, iss, ack), p in zip(sets, part)
                      if iss >= t_kill and int(p) in set(led)]
        learn = json.loads(_remote_command(node_addr[victim],
                                           "learn-status"))
        run.update(
            victim=victim, victim_led_partitions=len(led),
            failover_s=min(after_kill) if after_kill else None,
            failed_over_after_s=t_failed_over - t_kill,
            restart_s_after_kill=t_restart - t_kill,
            back_to_3_replicas_s=t_full - t_restart,
            learn={"ship_bytes": learn["ship.bytes"],
                   "ship_blocks": learn["ship.blocks"],
                   "delta_skipped_blocks": learn[
                       "ship.delta_skipped_blocks"],
                   "tail_mutations_replayed": learn[
                       "ship.replay_mutations"]})
        out["run"] = run

        # ---- read-back through batch dispatch and the kernel
        before = _kernel_counts(addrs)
        rb = pool.apply(_client_read_back, ("cluster",))
        after = _kernel_counts(addrs)
        rb["fence_launches"] = _delta(after, before,
                                      "kernel.fence_lookup.launches")
        if on_card and not sum(rb["fence_launches"].values()):
            raise AssertionError("the cluster read-back launched no "
                                 "fence-lookup kernel")
        out["read_back"] = rb
        step("read back")
        out["residency"] = check_residency(meta, coll, pool, progress,
                                           addrs, on_card)
        out["collector"] = check_collector(meta, coll, extra["http_port"],
                                           canary)
        step("residency leg")
        out["traces"] = check_traces(meta, addrs, CLUSTER_APP, n_parts)
        out["tables"] = check_tables(meta, CLUSTER_APP, run["ops_done"])
        step("traces and tables checked")
        out["sched"] = check_scheduler(meta, addrs, names, app_id, markers,
                                       loader, on_card)
        step("scheduler leg")

        parts, life = n_parts, {}
        if lifecycle:
            out["lifecycle"] = life
            # ---- cold backup, the read-back's answers its expected values
            backup_root = os.path.join(work, "backups")
            kept_keys = pool.apply(_client_snapshot)
            t0 = time.perf_counter()
            text = _shell(meta, f"backup_app {CLUSTER_APP} {backup_root}")
            backup_id = int(text.split("backup_id=")[1].split()[0])
            life["backup"] = {
                "seconds": time.perf_counter() - t0, "backup_id": backup_id,
                "bytes": sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(backup_root)
                             for f in fs),
                "keys_expected": kept_keys}
            step("backed up")

            # ---- the split, under load
            ship0 = {a: json.loads(_remote_command(a, "learn-status"))
                     ["ship.bytes"] for a in addrs}
            writers = _SplitWriters(meta, n_records,
                                    CLUSTER_SPLIT_THREADS).start()
            time.sleep(CLUSTER_SPLIT_MARGIN_S)
            t0 = time.perf_counter()
            sr = _meta_call(meta, RPC_CM_SPLIT_APP,
                            mm.SplitAppRequest(CLUSTER_APP),
                            mm.SplitAppResponse,
                            timeout=CLUSTER_DDL_TIMEOUT_S)
            split_s = time.perf_counter() - t0
            time.sleep(CLUSTER_SPLIT_MARGIN_S)
            load = writers.finish()
            if sr.error or sr.new_partition_count != 2 * n_parts:
                raise AssertionError(f"split: {sr}")
            parts = 2 * n_parts
            cfg = _config(meta, CLUSTER_APP)
            if cfg.app.partition_count != parts or any(
                    not pc.primary or len(pc.secondaries) != 2
                    for pc in cfg.partitions):
                raise AssertionError(f"split partitions: {cfg}")
            envs = json.loads(cfg.app.envs_json)
            if envs.get("replica.partition_version") != str(parts - 1) \
                    or "replica.split_pending" in envs:
                raise AssertionError(f"split envs: {envs}")
            learns = _learns(addrs, app_id, n_parts)
            prim = {pc.pidx: pc.primary for pc in cfg.partitions}
            seed = {k: sorted(s for p, a, s in learns
                              if (a == prim[p]) == (k == "primary"))
                    for k in ("primary", "secondary")}
            if len(seed["primary"]) != n_parts or \
                    len(seed["secondary"]) != 2 * n_parts:
                raise AssertionError(f"seeding learns: {learns}")
            overwritten = pool.apply(_client_absorb, (writers.acked,))
            life["split"] = {
                "seconds": split_s, "partitions": parts,
                "seed_s": {k: {"p50": v[len(v) // 2], "max": v[-1],
                               "learns": len(v)} for k, v in seed.items()},
                "learn_bytes": sum(json.loads(_remote_command(
                    a, "learn-status"))["ship.bytes"] - ship0[a]
                    for a in addrs),
                "writers": load, "overwrote_backed_up_keys": overwritten}
            step("split")

        # ---- manual compaction of every replica, through the meta (after
        # a split, the GC of the keys a partition no longer owns)
        pmask = parts - 1 if lifecycle else 0
        cfg = _config(meta, CLUSTER_APP)
        for a in addrs:
            _remote_command(a, "flush-memtable", timeout=300)
        snap = os.path.join(work, "pre_compaction")
        kept = _snapshot_runs(work, names, app_id,
                              [(pc.primary, pc.pidx) for pc in cfg.partitions],
                              snap)
        before = _kernel_counts(addrs)
        t0 = time.perf_counter()
        r = _meta_call(meta, RPC_CM_SET_APP_ENVS, mm.SetAppEnvsRequest(
            CLUSTER_APP, json.dumps({
                consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY:
                str(int(time.time()) - 1)})), mm.SetAppEnvsResponse,
            timeout=CLUSTER_DDL_TIMEOUT_S)
        if r.error:
            raise AssertionError(f"set app envs: {r.error_text}")
        wait_compacted(app_id, 3 * parts, t0)
        compact_s = time.perf_counter() - t0
        step("compacted")
        after = _kernel_counts(addrs)
        if on_card and not sum(_delta(after, before,
                                      "kernel.merge_path.launches").values()):
            raise AssertionError("the compaction launched no merge kernel")
        out["compaction"] = {
            "seconds": compact_s, "partition_mask": pmask,
            "merge_launches": _delta(after, before,
                                     "kernel.merge_path.launches"),
            "planes": check_compaction_planes(meta, addrs)}
        # the outputs are held to the cpu backend in this process while
        # the servers read back and audit
        checker = ThreadPoolExecutor(1)
        checking = checker.submit(_check_outputs, work, names, app_id, kept,
                                  pmask)

        if lifecycle:
            before = _kernel_counts(addrs)
            # the updated keys only (cut for the clock): the untouched
            # sample was read before the split and from the restore
            rb = pool.apply(_client_read_back, ("cluster after the split",),
                            {"sample": False})
            after = _kernel_counts(addrs)
            rb["fence_launches"] = _delta(after, before,
                                          "kernel.fence_lookup.launches")
            rb["partitions"] = parts
            life["split_read_back"] = rb
            step("read back through the split")

        # ---- the audit: every replica's digest at one decree
        t0 = time.perf_counter()
        caller = _caller(meta)
        try:
            report = run_cluster_audit([meta], apps=[CLUSTER_APP],
                                       wait_s=CLUSTER_CHECK_S, caller=caller)
        finally:
            caller.close()
        digests = report["digests"]
        if (report["mismatches"] or report["inconclusive"]
                or report["partitions"] != parts
                or sorted(report["ok"]) != sorted(digests)
                or any(len(d) != 3 or len({(x["decree"], x["digest"])
                                           for x in d.values()}) != 1
                       for d in digests.values())):
            raise AssertionError(f"audit: mismatches {report['mismatches']}"
                                 f", inconclusive {report['inconclusive']}"
                                 f", ok {len(report['ok'])} of {parts}")
        out["audit"] = {"seconds": time.perf_counter() - t0,
                        "digest_us": {names[a]: json.loads(_remote_command(
                            a, "perf-counters-by-prefix", ["audit."]))
                            for a in addrs},
                        "partitions": len(digests),
                        "replicas": sum(len(d) for d in digests.values()),
                        "records": sum(p["records"] for p in
                                       report["primaries"].values())}
        step("audited")
        out["doctor"] = check_doctor_healthy(meta, app_id, parts)
        step("doctor healthy")
        checked = checking.result()
        checker.shutdown()
        shutil.rmtree(snap)
        out["compaction"].update(check_s=checked.pop("seconds"), **checked)
        table_records = (sum(counts) + len(markers)
                         + out["traces"]["keys_written"]
                         + out["residency"]["rows"])
        if lifecycle and sum(checked["records_by_pidx"].values()) \
                != table_records:
            raise AssertionError(f"the primaries hold "
                                 f"{sum(checked['records_by_pidx'].values())}"
                                 f" records, the table {table_records}")
        step("compaction checked")

        if heal:
            out["heal"] = check_heal(
                meta, coll, extra["collector_http_port"], addrs, names, work,
                coll_env["PEGASUS_INCIDENT_DIR"], heal_rows, on_card)
            step("heal leg")

        if lifecycle:
            # ---- restore the backup into a new table and read it back
            t0 = time.perf_counter()
            _shell(meta, f"restore_app {backup_root} {backup_id} "
                         f"{CLUSTER_APP} {CLUSTER_RESTORED}")
            status, _ = _shell_poll(
                meta, f"query_restore_status {CLUSTER_RESTORED}", ": ok,")
            restore_s = time.perf_counter() - t0
            rcfg = _config(meta, CLUSTER_RESTORED)
            r_id = rcfg.app.app_id
            before = _kernel_counts(addrs)
            rb = pool.apply(_client_read_back, (
                "restored table", 4000, CLUSTER_RESTORED, True))
            after = _kernel_counts(addrs)
            rb["fence_launches"] = _delta(after, before,
                                          "kernel.fence_lookup.launches")
            life["restore"] = {"seconds": restore_s, "status": status.strip(),
                               "app_id": r_id, "read_back": rb}
            if on_card and not sum(rb["fence_launches"].values()):
                raise AssertionError("the restored read-back launched no "
                                     "fence-lookup kernel")
            step("restored")

            # ---- node compaction of the restored table: the batched
            # kernel, every replica's output held to the cpu backend's
            # compaction of the backup's runs it restored
            backed = {p: engine_files(os.path.join(
                backup_root, str(backup_id), CLUSTER_APP, str(p)))
                for p in range(n_parts)}
            kept = {(a, pc.pidx): backed[pc.pidx] for pc in rcfg.partitions
                    for a in [pc.primary] + pc.secondaries}
            before = _kernel_counts(addrs)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(addrs)) as ex:
                stats = dict(zip(addrs, ex.map(lambda a: json.loads(
                    _remote_command(a, "batched-manual-compact", [str(r_id)],
                                    timeout=CLUSTER_CHECK_S)), addrs)))
            node_s = time.perf_counter() - t0
            after = _kernel_counts(addrs)
            checked = _check_outputs(work, names, r_id, kept, 0)
            calls = _delta(after, before, "kernel.merge_path.launches")
            rows = _delta(after, before, "kernel.merge_path.rows")
            life["node_compaction"] = {
                "seconds": node_s, "stats": {names[a]: s
                                             for a, s in stats.items()},
                "merge_calls": calls, "merge_rows": rows,
                "check_s": checked["seconds"],
                "output_records": checked["output_records"]}
            if any(s["fallback"] or not s["batched"] for s in stats.values()):
                raise AssertionError(f"node compaction fell back: {stats}")
            if on_card and not all(rows[a] > calls[a] for a in addrs):
                raise AssertionError(f"node compaction did not batch: calls "
                                     f"{calls}, rows {rows}")
            life["node_compaction"]["jobs"] = check_node_compaction_jobs(
                meta, addrs, calls)
            step("restored table node-compacted")

        out["launches_per_process"] = {
            names[a]: c for a, c in _kernel_counts(addrs).items()}
        lock_graphs = {names[a]: json.loads(_remote_command(
            a, "perf-counters-by-prefix", ["lockrank."])) for a in addrs}
        out["collector_lockrank"] = json.loads(_remote_command(
            coll, "perf-counters-by-prefix", ["lockrank."]))
        if on_card:
            # this script's own process holds a context on the card too
            out["device_mib"] = {
                "before_kill": mem_before_kill, "end": _compute_apps(),
                "pids": {n: a.proc.pid for n, a in apps.items()},
                "this_pid": os.getpid()}
    finally:
        if saved_dir is None:
            os.environ.pop("PEGASUS_INCIDENT_DIR", None)
        else:
            os.environ["PEGASUS_INCIDENT_DIR"] = saved_dir
        if pool is not None:
            pool.terminate()
            pool.join()
        if loader is not None:
            loader.close()
        rcs = {}
        for name in [n for n in apps if n != "meta1"] + ["meta1"]:
            app = apps.get(name)
            if app is None:
                continue
            if app.alive():
                app.proc.send_signal(signal.SIGTERM)
                try:
                    app.proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    app.proc.kill()
                    app.proc.wait()
            rcs[name] = app.proc.returncode
    bad = {n: rc for n, rc in rcs.items() if rc != 0}
    if bad:
        raise AssertionError(f"cluster processes exited non-zero: {bad}; "
                             + "; ".join(f"{n}: {apps[n].tail()[-600:]}"
                                         for n in bad))
    out["stop_rcs"] = rcs
    out["lockrank"] = check_lockrank(lock_file, lock_graphs)
    return out


def ptxas_usage(report: str,
                kernel_re: str = r"merge_path_(splits|tile)_kernel") -> dict:
    """nvcc's -Xptxas -v report -> {kernel: {registers, smem_bytes,
    spill_stores, spill_loads}}, each kernel named by kernel_re's group."""
    import re

    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?" + kernel_re, line)
        if m:
            name = m.group(1)
            usage[name] = {"registers": 0, "smem_bytes": 0,
                           "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return usage


BUILT = ("merge_path", "fence_lookup")   # the sources under csrc/


def _parallel_build(names) -> list:
    """nvcc for every source at once (ops/_build.py). -> ptxas reports."""
    from concurrent.futures import ThreadPoolExecutor

    from pegasus_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(names)) as ex:
        return list(ex.map(_build.build, names))


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ab_main(argv) -> int:
    """`chip_smoke.py <phase>-measure TREE`: the record as the last line.
    `chip_smoke.py <phase>-ab TREE [TREE ...]`: the device line, then the
    records as `<phase>_ab` lines, then the nvidia-smi line."""
    phase, _, mode = argv[0].partition("-") if argv else ("", "", "")
    if phase not in MEASURES or mode not in ("measure", "ab") or (
            len(argv) < 2 or mode == "measure" and len(argv) != 2):
        print("usage: chip_smoke.py [fence|serve]-measure TREE | "
              "[fence|serve]-ab TREE [TREE ...]", file=sys.stderr)
        return 2
    if mode == "measure":
        print(json.dumps(globals()[MEASURES[phase]](argv[1])), flush=True)
        return 0
    import torch

    smi = _nvidia_smi()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    ab(phase, argv[1:])
    print(smi, flush=True)
    return 0


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    if argv:
        return ab_main(list(argv))
    sys.path.insert(0, ROOT)
    from pegasus_tpu_torch.ops import _build
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES

    started = time.perf_counter()
    if os.path.exists(PHASE_LOG):
        os.unlink(PHASE_LOG)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # every source's nvcc at once
    t0 = time.perf_counter()
    reports = dict(zip(BUILT, _parallel_build(BUILT)))
    ptxas = ptxas_usage(reports["merge_path"])
    ptxas_fence = ptxas_usage(reports["fence_lookup"],
                              r"(fence_search_kernelILi\d+)")
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         ptxas_fence_lookup=ptxas_fence)
    for src, usage in (("merge_path", ptxas), ("fence_lookup", ptxas_fence)):
        spills = {k: v for k, v in usage.items()
                  if v["spill_stores"] or v["spill_loads"]}
        if spills or not usage:
            raise AssertionError(f"{src}.cu spills registers or printed no "
                                 f"ptxas report: {usage}")

    kern = check_kernel(device)
    kern["mixed_widths"] = check_mixed_widths(device)
    kern_b = check_batched_kernel(device)
    fence, fence_dr, fence_keys = check_fence_kernel(device)
    emit("kernel", **kern, batched=kern_b, fence_lookup=fence)

    t0 = time.perf_counter()
    runs = fill(N_RECORDS)
    emit("fill", seconds=time.perf_counter() - t0,
         records=sum(r.n for r in runs), runs=len(runs))

    stage = profile_device_stage(runs, device)
    emit("device_stage", **stage)
    want, cpu_s = cpu_digest(runs)
    emit("cpu_backend", seconds=cpu_s, digest=want)

    work = os.path.join(ROOT, ".scratch", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        LAUNCHES["merge_path"] = LAUNCHES["merge_path_rows"] = 0
        eng, comp = run_compaction(os.path.join(work, "db"), runs, device,
                                   want)
        launches = LAUNCHES["merge_path"]
        if launches == 0:
            raise AssertionError("manual_compact launched no merge kernel")
        emit("compact", **comp)
        reads = run_reads(eng, runs, n_puts=200_000, n_gets=100_000,
                          n_ranges=1000)
        if reads["fence_launches"] == 0:
            raise AssertionError("the reads phase launched no fence-lookup "
                                 "kernel")
        # the kernel on the phase's own resident runs: the 10 M-record
        # compaction output, checked against the plain version and timed
        reads["fence_lookup_own"] = fence_on_engine(eng)
        reads["headroom"] = check_headroom(device,
                                           os.path.join(work, "headroom"))
        emit("reads", **reads)
        eng.close()
        del eng
        torch.cuda.empty_cache()
        eng, comp_v = run_compaction(os.path.join(work, "db_values"), runs,
                                     device, want, device_values=True)
        gather = comp_v["stages"]["gather"]
        if comp_v["merge_launches"] == 0 or gather["bytes"] == 0:
            raise AssertionError("device_values compaction did not gather "
                                 "its values on the device")
        emit("compact_values", **comp_v)
        eng.close()
        del eng
        torch.cuda.empty_cache()
        levels = run_levels(fill(LEVELS_RECORDS), device,
                            os.path.join(work, "levels"))
        emit("levels", **levels)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    blockwise = run_blockwise(runs, device, want, BLOCKWISE_BUDGET)
    for depth in (1, 2):
        if blockwise[f"depth{depth}"]["ranges"] < 3 or \
                blockwise[f"depth{depth}"]["merge_calls"] == 0:
            raise AssertionError(f"blockwise depth {depth} ran fewer than 3 "
                                 f"ranges or no merge kernel: {blockwise}")
    emit("blockwise", **blockwise)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    jobs = split_jobs(runs, device)
    post_opts = split_post_opts(jobs)
    split_s = time.perf_counter() - t0
    batched = run_batched(jobs, post_opts, device)
    k_runs = batched["runs_per_partition"]
    want_rows = (k_runs - 1) * len(jobs)
    if (batched["merge_calls"] != k_runs - 1
            or batched["merge_rows"] != want_rows):
        raise AssertionError(f"the batched group took {batched['merge_calls']}"
                             f" merge calls over {batched['merge_rows']} rows,"
                             f" not {k_runs - 1} over {want_rows}")
    del jobs
    # the batched merges' own operands, timed against the plain batched
    # merge and against one 2-D call per row
    own_b = [_time_batched(a, b, nk) for a, b, nk in batched.pop("operands")]
    emit("batched", split_s=split_s, merges=own_b, **batched)
    torch.cuda.empty_cache()

    os.makedirs(work, exist_ok=True)
    try:
        offload = run_offload(runs, device, os.path.join(work, "offload"))
        if offload["job"]["merge_launches"] < N_RUNS - 1:
            raise AssertionError(f"the offloaded job launched "
                                 f"{offload['job']['merge_launches']} merge "
                                 f"kernels on the service, not {N_RUNS - 1}")
        emit("offload", **offload)
        torch.cuda.empty_cache()
        emit("server", **run_server(runs, device,
                                    os.path.join(work, "server")))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del runs
    torch.cuda.empty_cache()

    os.makedirs(work, exist_ok=True)
    try:
        serve = run_serve(device, os.path.join(work, "serve"))
        emit("serve", **serve)
        # the fence kernel on a serve partition's run at the probe size
        # the serve read-backs' batches had (read.batch.size p50)
        p50 = max(1, int(serve["read_back_after_run"]["batch_size"]["p50"]))
        fence["serve_partition"]["batch_p50"] = time_fence(
            fence_dr, fence_keys, p50)
        emit("fence_probe", **fence["serve_partition"]["batch_p50"])
        del fence_dr, fence_keys
        if serve["ingest_merge_launches"] < SERVE_PARTITIONS or \
                serve["compaction"]["merge_launches"] < SERVE_PARTITIONS:
            raise AssertionError(
                f"merge-kernel launches below {SERVE_PARTITIONS}: ingest "
                f"{serve['ingest_merge_launches']}, compaction "
                f"{serve['compaction']['merge_launches']}")
        torch.cuda.empty_cache()
        replicate = run_replicate(device, os.path.join(work, "replicate"),
                                  os.path.join(work, "serve", "provider"))
        emit("replicate", **replicate)
        # every replica ingests 4 raw sets (3 merges) and compacts each of
        # its runs but the first into one (a merge per extra run)
        want_load = 3 * (SERVE_FILES - 1) * REPLICATE_GROUPS
        comp = replicate["compaction"]
        if replicate["load"]["merge_launches"] != want_load or \
                comp["merge_launches"] != comp["expected_launches"] or \
                comp["merge_launches"] < 3 * REPLICATE_GROUPS:
            raise AssertionError(
                f"replicate merge-kernel launches: load "
                f"{replicate['load']['merge_launches']} (want {want_load}),"
                f" compaction {comp['merge_launches']} (want "
                f"{comp['expected_launches']})")
        torch.cuda.empty_cache()
        geo = run_geo(device, os.path.join(work, "geo"))
        emit("geo", **geo)
        shutil.rmtree(os.path.join(work, "geo"), ignore_errors=True)
        torch.cuda.empty_cache()
        cluster = run_cluster(device, os.path.join(work, "cluster"),
                              os.path.join(work, "serve", "provider"),
                              serve["partition_records"], lifecycle=True,
                              heal=True)
        emit("cluster", **cluster)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit("elapsed", seconds=time.perf_counter() - started)
    # the kernel line: per launch, averaged over the compaction's own
    # merges (its operands, not synthetic keys)
    merges = stage["merges"]

    def per_launch(key):
        return sum(m[key] for m in merges) / len(merges)

    # the own-operand merges at the synthetic shape (4194304+4194304)
    half = [m["ms"] for m in merges if m["la"] == kern["large"]["la"]]
    own_half = sum(half) / len(half) if half else None

    # the fence lookup: per launch on a serve partition's run at 64
    # queries (`ms` the wrapper's calls back to back; `device_ms` the
    # kernel alone); its launches over the main path's reads (engine
    # reads, serve, replicate and cluster read-backs)
    life = cluster["lifecycle"]
    fence_launches = {
        "reads": reads["fence_launches"],
        "reads_headroom_pinned": reads["headroom"]["fence_launches"],
        "serve": sum(serve[k]["fence_launches"] for k in (
            "read_back_after_run", "read_back_after_compaction")),
        "replicate": replicate["read_back"]["fence_launches"],
        "cluster": sum(cluster["read_back"]["fence_launches"].values()),
        "cluster_residency_pinned": sum(
            cluster["residency"]["fence_launches"].values()),
        "cluster_split_read_back": sum(
            life["split_read_back"]["fence_launches"].values()),
        "cluster_restore_read_back": sum(
            life["restore"]["read_back"]["fence_launches"].values()),
        "geo": {"before_compaction": geo["search_before_compaction"]
                ["fence_launches"],
                "after_compaction": geo["search_after_compaction"]
                ["fence_launches"]},
        "cluster.heal": {
            leg: sum(cluster["heal"][leg]["read_back"]
                     ["fence_launches"].values())
            for leg in ("scrub", "autoheal")}}
    # the merge's launches on every path of the main run, per phase (the
    # cluster's scraped from its processes)
    node = life["node_compaction"]
    merge_launches = {
        "compact": launches,
        "levels": {f"depth{d}": levels[f"depth{d}"]["merge_launches"]
                   for d in (1, 2)},
        "serve": {"ingest": serve["ingest_merge_launches"],
                  "compaction": serve["compaction"]["merge_launches"]},
        "replicate": {"load": replicate["load"]["merge_launches"],
                      "compaction": replicate["compaction"]
                      ["merge_launches"]},
        "cluster": {"bulk_load_session": sum(
            cluster["load"]["merge_launches"].values()),
            "scheduler_leg": sum(cluster["sched"]["merge_launches"].values()),
            "split_gc_compaction": sum(
                cluster["compaction"]["merge_launches"].values())},
        "geo": {"ingest": geo["ingest_merge_launches"],
                "compaction": geo["compaction"]["merge_launches"]}}
    batched_launches = {
        "batched": {"calls": batched["merge_calls"],
                    "rows": batched["merge_rows"]},
        "cluster_restored_node_compaction": {
            "calls": sum(node["merge_calls"].values()),
            "rows": sum(node["merge_rows"].values())}}
    fence_64 = fence["serve_partition"]["64"]["point"]
    fence_line = {
        "name": "fence_lookup",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/fence_lookup.cu",
        "replaces": "pegasus_tpu/ops/device_lookup.py:63",
        "launches": _total(fence_launches),
        "max_abs_err": fence["max_abs_err"],
        "ms": fence_64["ms"],
        "plain_ms": fence_64["plain_ms"],
        "bound_ms": fence_64["bound_ms"],
        "bound_by": fence_64["bound_by"],
        "library_ms": None,
        "device_ms": fence_64["device_ms"],
        "device_ms_cold": fence_64["device_ms_cold"],
        "host_us": fence_64["host_us"],
        "rounds": fence_64["rounds"],
        "binary_rounds": fence_64["binary_rounds"],
        "chain_loads": fence_64["chain_loads"],
        "launches_by_phase": fence_launches,
        "serve_partition": fence["serve_partition"],
        "compaction_output": reads["fence_lookup_own"],
        "ptxas": ptxas_fence,
    }
    print(json.dumps({"kernels": [{
        "name": "merge_path",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/merge_path.cu",
        "replaces": "pegasus_tpu/ops/pallas_merge.py:324",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": per_launch("ms"),
        "plain_ms": per_launch("plain_ms"),
        "bound_ms": per_launch("bound_ms"),
        "bound_by": merges[0]["bound_by"],
        "library_ms": None,
        "bound_ms_int64": per_launch("bound_ms_int64"),
        "synthetic_ms": kern["large"]["ms"],
        "synthetic_shared_prefix_ms": kern["large_shared_prefix"]["ms"],
        "own_over_synthetic": (own_half / kern["large"]["ms"]
                               if own_half else None),
        "launches_by_phase": merge_launches,
        "ptxas": ptxas,
    }, {
        "name": "merge_path_batched",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/merge_path.cu",
        "replaces": "pegasus_tpu/ops/pallas_merge.py:324",
        "launches": batched["merge_calls"],
        "rows": batched["merge_rows"],
        "max_abs_err": max(kern_b["max_abs_err"],
                           max(m["max_abs_err"] for m in own_b)),
        "ms": sum(m["ms"] for m in own_b) / len(own_b),
        "plain_ms": sum(m["plain_ms"] for m in own_b) / len(own_b),
        "bound_ms": sum(m["bound_ms"] for m in own_b) / len(own_b),
        "bound_by": own_b[0]["bound_by"],
        "library_ms": None,
        "sequential_ms": sum(m["sequential_ms"] for m in own_b) / len(own_b),
        "bound_ms_int64": sum(m["bound_ms_int64"] for m in own_b)
        / len(own_b),
        "batch": own_b[0]["batch"],
        "synthetic_ms": kern_b["timed"]["ms"],
        "synthetic_sequential_ms": kern_b["timed"]["sequential_ms"],
        "launches_by_phase": batched_launches,
        "ptxas": ptxas,
    }, fence_line]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _total(counts) -> int:
    """The sum of a launch-count dict's numbers, nested dicts included."""
    return sum(_total(v) if isinstance(v, dict) else v
               for v in counts.values())


def _child_pids() -> list:
    """The pids of this process's children that have not been reaped,
    from /proc/<pid>/stat (its 4th field is the parent's pid)."""
    me, kids = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rpartition(")")[2].split()[1]) == me:
            kids.append(int(name))
    return kids


def _stop_processes() -> None:
    """Ends every process this script started and has not ended, and
    reaps it, so that none outlives the script. First multiprocessing's
    own exit sequence (pools terminated, their semaphores unlinked),
    then any child a phase left running (reported on stderr), then the
    resource tracker the spawn pools started: Pythons without
    ResourceTracker.__del__ leave it running past the script's exit."""
    import signal
    from multiprocessing import resource_tracker, util

    util._exit_function()
    tracker = resource_tracker._resource_tracker
    for pid in _child_pids():
        if pid == tracker._pid:
            continue
        print(f"chip_smoke: stopping leftover child process {pid}",
              file=sys.stderr)
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    if tracker._fd is None or tracker._pid is None:
        return
    # the tracker ends when every holder of its pipe has closed it (the
    # pool workers, its other holders, are gone); it ignores SIGINT and
    # SIGTERM
    os.close(tracker._fd)
    tracker._fd = None
    deadline = time.monotonic() + 60
    while os.waitpid(tracker._pid, os.WNOHANG) == (0, 0):
        if time.monotonic() > deadline:
            os.kill(tracker._pid, signal.SIGKILL)
            os.waitpid(tracker._pid, 0)
            break
        time.sleep(0.05)
    tracker._pid = None


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    finally:
        _stop_processes()
    sys.exit(rc)
