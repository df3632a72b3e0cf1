"""Audit-driven auto-heal: close the detect -> quarantine -> heal loop
from the collector side.

Port of pegasus_tpu/collector/auto_heal.py, whole. The decree-anchored
audits NAME the divergent replica (the doctor's
``evidence.audit.mismatches`` carries gpid + node + decree + both
digests), and every replica node's ``quarantine-replica`` remote command
turns a named copy into a forensics dir plus a beacon-reported
QUARANTINED state that the meta re-seeds (``repair_quarantined``). This
module is the small, deliberately paranoid driver in between: it
watches doctor verdicts and, when the evidence isolates EXACTLY ONE odd
replica, quarantines that replica so the repair machinery rebuilds it
from the healthy quorum through the block-shipped learn. On a cuda node
the re-seeded engine primes its learned runs on the card.

Interlocks (an auto-healer's first duty is to never make things worse):

* gated off entirely unless ``PEGASUS_AUTOHEAL=1``;
* only CRITICAL verdicts act; inconclusive verdicts and pending audit
  evidence (unequal decrees, no-majority ties) never reach the
  mismatch list in the first place (`_check_audit` guarantees that);
* per partition, every mismatch must name the SAME single node: two
  replicas disagreeing with the reference means the reference itself is
  suspect, so no action;
* process-wide rate limit (``PEGASUS_AUTOHEAL_MIN_INTERVAL_S``, default
  60s): at most one quarantine per window, so a systemic corruption
  wave (bad disk firmware, a poisoned write path) cannot let the healer
  serially destroy every copy the cluster has.
"""

import os
import time

from ..runtime import events, lockrank
from ..runtime.perf_counters import counters


class AutoHealer:
    """Doctor-verdict observer: audit mismatch -> targeted quarantine."""

    def __init__(self):
        self._lock = lockrank.named_lock("autoheal.state")
        # None = never acted (monotonic starts near 0 on a fresh boot —
        # a 0.0 sentinel would falsely rate-limit the FIRST heal)
        self._last_action = None  #: guarded_by self._lock

    @staticmethod
    def _enabled() -> bool:
        return os.environ.get("PEGASUS_AUTOHEAL", "") == "1"

    @staticmethod
    def _min_interval() -> float:
        return float(os.environ.get("PEGASUS_AUTOHEAL_MIN_INTERVAL_S", "60"))

    def observe_verdict(self, verdict: dict, caller) -> list:
        """-> list of {"gpid", "node"} actions taken (empty when gated,
        interlocked, rate-limited, or nothing to heal)."""
        if not self._enabled() or verdict.get("verdict") != "critical":
            return []
        mismatches = verdict.get("evidence", {}) \
                            .get("audit", {}).get("mismatches") or []
        if not mismatches:
            return []
        by_gpid = {}
        for m in mismatches:
            by_gpid.setdefault(m["gpid"], []).append(m)
        actions = []
        for gpid, ms in sorted(by_gpid.items()):
            odd = {m["node"] for m in ms}
            if len(odd) != 1:
                # quorum does not isolate one replica: the reference
                # digest itself is suspect — never quarantine on it
                counters.rate("autoheal.vetoed_count").increment()
                events.emit("autoheal.veto", "warn", gpid=gpid,
                            nodes=sorted(odd),
                            reason="mismatch names multiple replicas")
                continue
            now = time.monotonic()
            with self._lock:
                if self._last_action is not None \
                        and now - self._last_action < self._min_interval():
                    counters.rate("autoheal.vetoed_count").increment()
                    continue  # rate-limited: next doctor round retries
                self._last_action = now
            node = next(iter(odd))
            reason = (f"audit digest mismatch at decree {ms[0]['decree']} "
                      f"(got {ms[0]['digest'][:16]} want "
                      f"{ms[0]['expected'][:16]})")
            try:
                caller.remote_command(node, "quarantine-replica",
                                      [gpid, reason])
            except Exception as e:  # noqa: BLE001 - heal is best-effort;
                # the replica may already be quarantined or the node gone
                print(f"[autoheal] {gpid}@{node}: {e!r}", flush=True)
                continue
            counters.rate("autoheal.quarantine_count").increment()
            events.emit("autoheal.quarantine", "warn", gpid=gpid,
                        node=node, reason=reason)
            actions.append({"gpid": gpid, "node": node})
        return actions


AUTO_HEALER = AutoHealer()
