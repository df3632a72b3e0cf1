"""Duplicator bootstrap: seed a fresh remote cluster by block ship.

Port of pegasus_tpu/replication/bootstrap.py. A table whose mutation log
no longer reaches back to decree 0 (log GC behind the durable SSTs is
the normal state of a long-lived table) cannot seed a remote cluster by
log replay. The bootstrap uses the machinery learners use instead:

  1. for every source partition, open a learn session against its
     primary (the pin / manifest / chunk protocol of a learner's re-seed,
     delta-aware and resumable: a re-run of an interrupted bootstrap
     fetches only the blocks its staging dir is missing);
  2. stage the pinned checkpoint's SST blocks into a bulk-load provider
     layout (``<root>/<app>/<partition_count>/<pidx>/*.sst``);
  3. drive the destination meta's replicated bulk-load ingest: every
     destination replica ingests the set at the same decree through the
     PacificA write path (on a cuda node, through the merge kernel when a
     partition ships more than one SST), so the bootstrap survives a
     destination failover.

Run it with the duplication added frozen (the dup entry holds the source
logs at its confirmed decree), then start the duplication: the log tail
ships the window after the checkpoint, and the cross-cluster audit
(collector/cluster_doctor.run_cross_cluster_audit) proves the table
byte-consistent at the confirmed decree.

The port ships SHIP_WORKERS partitions at once where the reference walks
them one by one; the totals are the serial walk's. A failed ship or
ingest raises: nothing falls back.
"""

import os
from concurrent.futures import ThreadPoolExecutor

from ..engine.bulk_load import write_metadata
from ..meta import messages as mm
from ..meta.meta_server import RPC_CM_START_BULK_LOAD
from ..rpc import codec
from ..rpc.transport import ConnectionPool, RpcError
from .learn import RemoteLearnSource, dir_manifest, stage_blocks

# engine-internal files that ride a checkpoint manifest but are not
# ingestable blocks (the provider set is SSTs only)
_NON_BLOCK = {"MANIFEST"}

SHIP_WORKERS = 8        # source partitions shipped at once
INGEST_TIMEOUT_S = 120.0  # the destination's synchronous bulk-load DDL


def ship_partition_blocks(pool: ConnectionPool, primary: str, app_id: int,
                          pidx: int, dest_dir: str) -> dict:
    """Block-ship one source partition's pinned checkpoint SSTs into
    `dest_dir` (delta / resume against what is already staged there).
    -> stage_blocks' stats + the checkpoint decree."""
    src = RemoteLearnSource(pool, primary, app_id, pidx)
    st = src.prepare_learn_state(have=dir_manifest(dest_dir))
    try:
        st = dict(st, blocks=[e for e in st["blocks"]
                              if e["name"] not in _NON_BLOCK])
        stats = stage_blocks(src, st, dest_dir)
    finally:
        src.finish_learn(st["learn_id"])
    return dict(stats, ckpt_decree=st["ckpt_decree"])


def bootstrap_remote_cluster(src_meta_addrs, dst_meta_addrs, app_name: str,
                             provider_root: str,
                             pool: ConnectionPool = None,
                             ingest_timeout: float = INGEST_TIMEOUT_S) -> dict:
    """Seed `app_name` on the destination cluster from the source
    cluster's checkpoints, by block ship and a replicated bulk-load
    ingest. The destination table must exist with the same partition
    count (the ingest's hash filter then keeps exactly each partition's
    rows). -> {"partitions", "blocks", "bytes", "skipped", "resumed",
    "ingested_records"}."""
    from ..collector.cluster_doctor import ClusterCaller

    own_pool = pool is None
    pool = pool or ConnectionPool()
    caller = ClusterCaller(src_meta_addrs, pool=pool)
    try:
        state = caller.meta_state()
        if state is None or app_name not in state.get("apps", {}):
            raise RuntimeError(
                f"source cluster state unavailable or no app {app_name!r}")
        app = state["apps"][app_name]
        app_id, pcount = app["app_id"], app["partition_count"]
        for pc in app["partitions"]:
            if not pc.get("primary"):
                raise RuntimeError(
                    f"partition {pc['pidx']} has no live primary")

        def ship(pc):
            dest = os.path.join(provider_root, app_name, str(pcount),
                                str(pc["pidx"]))
            return ship_partition_blocks(pool, pc["primary"], app_id,
                                         pc["pidx"], dest)

        totals = {"partitions": 0, "blocks": 0, "bytes": 0, "skipped": 0,
                  "resumed": 0}
        parts = app["partitions"]
        with ThreadPoolExecutor(max(1, min(SHIP_WORKERS, len(parts))),
                                thread_name_prefix="bootstrap") as ex:
            for stats in ex.map(ship, parts):
                totals["partitions"] += 1
                totals["blocks"] += stats["fetched"]
                totals["bytes"] += stats["bytes"]
                totals["skipped"] += stats["skipped"]
                totals["resumed"] += stats["resumed"]
        write_metadata(provider_root, app_name, pcount)
        resp = _start_bulk_load(pool, dst_meta_addrs, app_name,
                                provider_root, ingest_timeout)
        totals["ingested_records"] = resp.ingested_records
        return totals
    finally:
        if own_pool:
            pool.close()


def _start_bulk_load(pool, dst_meta_addrs, app_name: str,
                     provider_root: str, timeout: float = INGEST_TIMEOUT_S):
    """The synchronous bulk-load DDL against the destination meta (the
    first reachable leader wins)."""
    last = None
    for meta in dst_meta_addrs:
        host, _, port = meta.rpartition(":")
        try:
            conn = pool.get((host, int(port)))
            _, body = conn.call(
                RPC_CM_START_BULK_LOAD,
                codec.encode(mm.StartBulkLoadRequest(
                    app_name=app_name, provider_root=provider_root)),
                timeout=timeout)
        except (RpcError, OSError) as e:
            last = e
            continue
        resp = codec.decode(mm.StartBulkLoadResponse, body)
        if resp.error:
            raise RuntimeError(f"destination bulk load failed: "
                               f"{resp.error_text}")
        return resp
    raise RuntimeError(f"no destination meta reachable: {last!r}")
