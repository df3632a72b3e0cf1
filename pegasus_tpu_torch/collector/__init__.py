"""The collector's cluster-level consumers: the consistency audit,
the cluster doctor and the compaction scheduler.

Port of pegasus_tpu/collector/, the parts these need. The collector role
itself (CollectorApp), the info collector's scraping, hotkey and SLO
loops, the availability detector, the counter reporters, the flight
recorder and auto-heal are not ported yet (ROADMAP Queue 1): until the
role lands, callers run the audit, the doctor and the scheduler's ticks
in their own process (the shell, tests, chip_smoke.py).
"""

from .cluster_doctor import (ClusterCaller, run_cluster_audit,
                             run_cluster_doctor)
from .compact_scheduler import CompactScheduler, run_scheduler_tick

__all__ = ["ClusterCaller", "run_cluster_audit", "run_cluster_doctor",
           "CompactScheduler", "run_scheduler_tick"]
