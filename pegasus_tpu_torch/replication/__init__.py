"""Replica-node planes: PacificA replication (mutation log, replica,
streamed learn, the in-process replica group), cross-cluster duplication
(duplicator.py, bootstrap.py) and the compaction-offload service with its
client."""

from .group import ReplicaGroup
from .mutation_log import LogMutation, MutationLog
from .replica import (GroupView, LEARNER, PRIMARY, PrepareRejected, Replica,
                      ReplicaError, SECONDARY)

__all__ = [
    "ReplicaGroup", "LogMutation", "MutationLog", "GroupView", "Replica",
    "ReplicaError", "PrepareRejected", "PRIMARY", "SECONDARY", "LEARNER",
]
