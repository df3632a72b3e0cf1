"""Replica-node planes: the compaction-offload service and its client."""
