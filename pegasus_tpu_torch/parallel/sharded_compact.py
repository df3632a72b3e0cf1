"""The offload service's merge entry.

Port of pegasus_tpu/parallel/sharded_compact.py's `compact_blocks_meshed`
without its lane guard: on one card it is `compact_blocks`, and a build,
launch or device failure raises to the caller. The hash-sharded merge
across several cards (the reference's all_to_all routing) is not ported
yet (ROADMAP Queue 1 item 4).
"""

from ..ops.compact import CompactOptions, CompactResult, compact_blocks


def compact_blocks_meshed(blocks, opts: CompactOptions,
                          mesh=None) -> CompactResult:
    """Merge `blocks` (newest first) on what the host owns. `mesh` is a
    sequence of devices; None or one device is the single-card merge."""
    if mesh is not None and len(mesh) > 1:
        raise NotImplementedError(
            "merging across several cards is not ported yet (ROADMAP "
            "Queue 1 item 4: the sharded path)")
    return compact_blocks(blocks, opts)
