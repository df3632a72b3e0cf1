"""Batched multi-partition compaction: many partitions' merges in one
dispatch.

Port of pegasus_tpu/ops/batched_compact.py. A replica node hosts many
partitions whose compactions are independent. The reference vmaps its
cached-run pipeline over a leading partition axis; here the same pipeline
(ops/compact.py _make_cached_fn) runs over a leading batch axis, and its
merges are batched merge-path launches (ops/merge_path.py: a grid row per
partition). A group of B partitions with K runs each takes K-1 merge
calls, not B x (K-1), and one download of the B survivor counts.

Partitions are grouped by their shape signature (padded run lengths, run
widths, w); a group is chunked so one dispatch stacks at most
opts.max_device_records rows, and the next chunk's stack (device-to-device
copies of the runs' resident columns) is prefetched on the pipeline
(ops/pipeline.py) under the current chunk's dispatch. A single partition
above that budget goes through compact_blocks, and so blockwise.

There is no lane guard: a build, launch or device failure raises to the
caller. Sharding the batch over several cards (the reference's `mesh`)
is not ported yet.
"""

from dataclasses import replace

import torch

from ..engine.block import KVBlock
from ..runtime.tracing import COMPACT_TRACER as _TRACE
from .compact import (CompactOptions, _make_cached_fn, _real_offsets,
                      _SideStream, apply_post_filters, compact_blocks,
                      gather_device_survivors, resolve_device)
from .pipeline import CompactPipeline


def _signature(device_runs):
    return (tuple(r.padded_len for r in device_runs),
            tuple(r.w for r in device_runs),
            max(r.w for r in device_runs))


def _stack_group(jobs, device):
    """jobs: list of (device_runs, pidx) of one signature. -> the batched
    pipeline's per-row inputs: per run (kcols [B, w_i, P_i], klen
    [B, P_i]) and (expire, deleted, hash32) each [B, P_i], the runs'
    offsets in each row's real concat [B, K] and pidx [B, 1], all on
    `device`."""
    k = len(jobs[0][0])
    cached = tuple((torch.stack([job[0][i].cols for job in jobs]),
                    torch.stack([job[0][i].klen for job in jobs]))
                   for i in range(k))
    aux = tuple((torch.stack([job[0][i].expire for job in jobs]),
                 torch.stack([job[0][i].deleted for job in jobs]),
                 torch.stack([job[0][i].hash32 for job in jobs]))
                for i in range(k))
    real_off = torch.tensor([_real_offsets(job[0]) for job in jobs],
                            dtype=torch.int64, device=device)
    pidx = torch.tensor([[job[1]] for job in jobs], dtype=torch.int64,
                        device=device)
    return cached, aux, real_off, pidx


def _stack_and_place(jobs, idxs, sig, device):
    """A chunk's "h2d" stage: stack its partitions' resident runs on the
    batch axis (device-to-device copies; the host upload happened when
    each DeviceRun was primed)."""
    padded_lens, _, _ = sig
    with _TRACE.span("h2d", records=len(idxs) * sum(padded_lens)) as sp:
        stacked = _stack_group([(jobs[j][1], jobs[j][2]) for j in idxs],
                               device)
        sp["bytes"] = sum(t.numel() * t.element_size()
                          for group in stacked[0] + stacked[1] for t in group)
    return stacked


def compact_partition_batch(jobs, opts: CompactOptions, mesh=None,
                            post_opts=None):
    """jobs: list of (runs: [KVBlock], device_runs: [DeviceRun], pidx).
    Every job's runs must be sorted and every run device-resident; jobs
    of any shapes may share a call: they are grouped by signature here,
    one dispatch per group (or per chunk of one). -> list of output
    KVBlocks, in job order.

    Byte-equal to compact_blocks(runs, opts with pidx = the job's pidx,
    device_runs=...) per job. post_opts: optional per-job
    CompactOptions for the host post passes (user rules, default_ttl);
    now, partition_mask, bottommost and filter come from `opts` for
    every job. The merges run on the device of opts.device.

    mesh: sharding the batch axis over several cards is not ported; any
    mesh raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(
            "compact_partition_batch: the mesh (batch axis over several "
            "cards) is not ported; pass mesh=None")
    now = opts.resolved_now()
    device = resolve_device(opts.device)
    outs = [None] * len(jobs)
    groups = {}
    for j, (runs, device_runs, pidx) in enumerate(jobs):
        if not runs or any(d is None for d in device_runs):
            raise ValueError(f"job {j}: all runs must be device-cached")
        if sum(d.padded_len for d in device_runs) > opts.max_device_records:
            outs[j] = compact_blocks(runs, _job_opts(opts, post_opts, j,
                                                     pidx, now),
                                     device_runs=device_runs).block
            continue
        groups.setdefault(_signature(device_runs), []).append(j)
    chunks = []
    for sig, all_idxs in groups.items():
        # one dispatch stacks B x sum(padded_lens) rows: chunk the group
        # rather than exceed the device budget
        per_job = sum(sig[0])
        max_b = max(1, int(opts.max_device_records // max(1, per_job)))
        for at in range(0, len(all_idxs), max_b):
            chunks.append((sig, all_idxs[at: at + max_b]))
    side = _SideStream(device)

    def _prefetch(chunk):
        sig, idxs = chunk
        return side.run(_stack_and_place, jobs, idxs, sig, device)

    def _dispatch(i, pre):
        sig, idxs = chunks[i]
        stacked, ev = pre
        side.adopt([t for group in stacked[0] + stacked[1] for t in group]
                   + list(stacked[2:]), ev)
        _run_group(jobs, idxs, sig, opts, now, stacked, outs, post_opts)

    CompactPipeline().map(chunks, _prefetch, _dispatch)
    return outs


def _job_opts(opts, post_opts, j, pidx, now) -> CompactOptions:
    """Job j's options for the per-job paths: its own post-pass options,
    with the in-dispatch knobs and the clock of the batch."""
    return replace(post_opts[j] if post_opts else opts,
                   pidx=pidx, now=now, backend="cuda", device=opts.device,
                   runs_sorted=True, partition_mask=opts.partition_mask,
                   bottommost=opts.bottommost, filter=opts.filter)


def _run_group(jobs, idxs, sig, opts, now, stacked, outs,
               post_opts=None) -> None:
    """One dispatch: the batched cached pipeline over a chunk's stacked
    runs, one download of the survivor counts, then each row's survivors
    gathered and post-filtered on the host into outs[job]."""
    padded_lens, run_ws, w = sig
    fn = _make_cached_fn(padded_lens, run_ws, w)
    cached, aux, real_off, pidx = stacked
    with _TRACE.span("device", records=len(idxs) * sum(padded_lens)):
        out_idx, counts = fn(cached, aux, real_off, now, pidx,
                             opts.partition_mask, bool(opts.bottommost),
                             bool(opts.filter))
        counts = counts.cpu().tolist()  # one download: waits for the batch
    for row, j in enumerate(idxs):
        runs = jobs[j][0]
        concat = runs[0] if len(runs) == 1 else KVBlock.concat(runs)
        out = gather_device_survivors(concat, out_idx[row], counts[row])
        outs[j] = apply_post_filters(
            out, post_opts[j] if post_opts else opts, now)
