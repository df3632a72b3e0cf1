"""The part of the info collector the cluster doctor reads.

Port of pegasus_tpu/collector/info_collector.py:40-106: the latest
per-table SLO verdicts and the cluster-wide slow-request rollup. The
collector's scraping loop, hotspot analysis, hotkey loop and the SLO
evaluator are not ported yet (ROADMAP Queue 1), so no process of the
port evaluates SLOs and latest_slo() reads {}.
"""

import json

from ..rpc.transport import RpcError

# the most recent per-table SLO verdicts computed IN THIS PROCESS; the
# evaluator rebinds it wholesale, so lock-free readers see a stable dict
_SLO_LATEST = {}


def latest_slo() -> dict:
    """Per-table SLO verdicts from the last evaluation in this process:
    {table: {"verdict": ok|warn|burning, ...evidence}}."""
    return _SLO_LATEST


def reset_slo() -> None:
    """Test hook: forget the verdicts."""
    global _SLO_LATEST
    _SLO_LATEST = {}


def rollup_slow_requests(fetch, nodes, last: int = 20) -> list:
    """Cluster-wide slow-request rollup: merge every node's
    `slow-requests` output (a JSON list of traces with their spans) into
    ONE worst-first top-`last`, each trace tagged with the node it came
    from. `fetch(node)` is the transport (a remote command); it may
    return the raw JSON text or a parsed list. A node that does not
    answer is skipped: a rollup degrades, it never raises."""
    merged = []
    for node in nodes:
        try:
            raw = fetch(node)
            traces = json.loads(raw) if isinstance(raw, str) else raw
        except (RpcError, OSError, ValueError):
            continue
        if not isinstance(traces, list):
            continue
        for t in traces:
            if isinstance(t, dict):
                merged.append(dict(t, node=node))
    merged.sort(key=lambda t: t.get("duration_us", 0), reverse=True)
    return merged[:last]
