"""The collector: the info collector (scrapes, the hotkey loop, the
cluster rollups and the SLO evaluator), the availability canary, the
counter reporter, the consistency audit, the cluster doctor, the
compaction scheduler, the flight recorder and the audit-driven
auto-healer.

Port of pegasus_tpu/collector/. The collector role that hosts these
loops is runtime/service_app.py's CollectorApp.
"""

from .auto_heal import AUTO_HEALER
from .available_detector import AvailableDetector
from .cluster_doctor import (ClusterCaller, run_cluster_audit,
                             run_cluster_doctor)
from .compact_scheduler import CompactScheduler, run_scheduler_tick
from .flight_recorder import RECORDER
from .info_collector import InfoCollector, hotspot_partitions
from .reporter import CounterReporter, falcon_payload, prometheus_text

__all__ = ["AvailableDetector", "InfoCollector", "hotspot_partitions",
           "CounterReporter", "falcon_payload", "prometheus_text",
           "ClusterCaller", "run_cluster_audit", "run_cluster_doctor",
           "CompactScheduler", "run_scheduler_tick", "AUTO_HEALER",
           "RECORDER"]
