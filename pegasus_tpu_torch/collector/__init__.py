"""The collector: the info collector (scrapes, the hotkey loop, the
cluster rollups and the SLO evaluator), the availability canary, the
counter reporter, the consistency audit, the cluster doctor and the
compaction scheduler.

Port of pegasus_tpu/collector/. The flight recorder and auto-heal are not
ported yet (ROADMAP Queue 1 item 3). The collector role that hosts these
loops is runtime/service_app.py's CollectorApp.
"""

from .available_detector import AvailableDetector
from .cluster_doctor import (ClusterCaller, run_cluster_audit,
                             run_cluster_doctor)
from .compact_scheduler import CompactScheduler, run_scheduler_tick
from .info_collector import InfoCollector, hotspot_partitions
from .reporter import CounterReporter, falcon_payload, prometheus_text

__all__ = ["AvailableDetector", "InfoCollector", "hotspot_partitions",
           "CounterReporter", "falcon_payload", "prometheus_text",
           "ClusterCaller", "run_cluster_audit", "run_cluster_doctor",
           "CompactScheduler", "run_scheduler_tick"]
